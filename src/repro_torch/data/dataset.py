"""Versioned dataset store (paper C8 / §4.1, §2.4 data consistency): the
port's own copy of ``repro.data.dataset`` (numpy only, no torch).

Every sample is content-addressed (sha1 of its bytes and label) and
assigned a deterministic train/val/test split from its hash: adding or
removing samples never reshuffles anyone else's split, the paper's
"maintaining train/validation/test splits ... adding or removing
individual samples" requirement.  Dataset versions are manifest files
(sample ids and metadata), so checkout and diff are cheap and the data,
not the storage, defines the version.  Ids, splits, version hashes and
manifests are the JAX package's for the same samples.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

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


def split_of(sample_id: str, val_frac: float = 0.1, test_frac: float = 0.2
             ) -> str:
    """Deterministic split from the content hash."""
    u = int(sample_id[:8], 16) / 0xFFFFFFFF
    if u < test_frac:
        return "test"
    if u < test_frac + val_frac:
        return "val"
    return "train"


class Dataset:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root else None
        self.samples: Dict[str, Sample] = {}
        if self.root:
            (self.root / "blobs").mkdir(parents=True, exist_ok=True)
            (self.root / "versions").mkdir(parents=True, exist_ok=True)

    # -- mutation ------------------------------------------------------
    def add(self, sample: Sample) -> str:
        self.samples[sample.sample_id] = sample
        if self.root:
            blob = self.root / "blobs" / f"{sample.sample_id}.npz"
            if not blob.exists():
                np.savez_compressed(
                    blob, data=sample.data, label=sample.label,
                    metadata=json.dumps(sample.metadata))
        return sample.sample_id

    def add_many(self, samples: Iterable[Sample]) -> List[str]:
        return [self.add(s) for s in samples]

    def remove(self, sample_id: str) -> None:
        self.samples.pop(sample_id, None)

    # -- versioning ------------------------------------------------------
    def commit(self, message: str = "") -> str:
        ids = sorted(self.samples)
        h = hashlib.sha1("".join(ids).encode()).hexdigest()[:12]
        if self.root:
            manifest = {
                "version": h, "message": message, "time": time.time(),
                "samples": [
                    {"id": sid, "label": self.samples[sid].label,
                     "split": split_of(sid),
                     "metadata": self.samples[sid].metadata}
                    for sid in ids],
            }
            (self.root / "versions" / f"{h}.json").write_text(
                json.dumps(manifest, indent=1))
        return h

    def checkout(self, version: str) -> "Dataset":
        if not self.root:
            raise ValueError("versioning requires a rooted dataset")
        manifest = json.loads(
            (self.root / "versions" / f"{version}.json").read_text())
        ds = Dataset(self.root)
        for rec in manifest["samples"]:
            blob = np.load(self.root / "blobs" / f"{rec['id']}.npz",
                           allow_pickle=False)
            ds.samples[rec["id"]] = Sample(
                data=blob["data"], label=int(blob["label"]),
                metadata=json.loads(str(blob["metadata"])),
                sample_id=rec["id"])
        return ds

    def versions(self) -> List[str]:
        if not self.root:
            return []
        return sorted(p.stem for p in (self.root / "versions").glob("*.json"))

    # -- access ----------------------------------------------------------
    def split(self, name: str) -> List[Sample]:
        return [s for sid, s in sorted(self.samples.items())
                if split_of(sid) == name]

    def arrays(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        part = self.split(name)
        if not part:
            return np.zeros((0,)), np.zeros((0,), np.int32)
        xs = np.stack([s.data for s in part])
        ys = np.asarray([s.label for s in part], np.int32)
        return xs, ys

    def class_counts(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for s in self.samples.values():
            out[s.label] = out.get(s.label, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.samples)
