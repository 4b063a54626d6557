"""A dataset sample (paper C8 / §4.1): the port's own copy of
``repro.data.dataset.Sample`` (numpy only, no torch).

Every sample is content-addressed: its id is the sha1 of its bytes and
label.  The versioned ``Dataset`` store comes with the port's ingest and
pipeline slice, the first that uses it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass
class Sample:
    data: np.ndarray
    label: int
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    sample_id: str = ""

    def __post_init__(self):
        if not self.sample_id:
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(self.data).tobytes())
            h.update(str(self.label).encode())
            self.sample_id = h.hexdigest()
