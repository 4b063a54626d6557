"""Multi-format ingestion (paper §4.1): CSV / JSON / WAV / NPY → Sample.
The port's own copy of ``repro.data.ingest`` (numpy and the standard
library only): the same bytes give the same samples.

The platform accepts "CSV, CBOR, JSON, WAV, JPG, or PNG"; this offline
environment covers the text/audio/array formats with stdlib parsers
(wave, csv, json) — image formats would slot in identically behind
``INGESTORS``.
"""
from __future__ import annotations

import csv
import io
import json
import wave
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.dataset import Sample


def ingest_csv(path_or_bytes, label: int,
               metadata: Optional[Dict] = None) -> Sample:
    """CSV of one time series: columns are channels, rows are steps."""
    if isinstance(path_or_bytes, (str, Path)):
        text = Path(path_or_bytes).read_text()
    else:
        text = path_or_bytes.decode()
    rows = [[float(v) for v in r] for r in csv.reader(io.StringIO(text))
            if r and not r[0].startswith("#")]
    arr = np.asarray(rows, np.float32)
    if arr.shape[1] == 1:
        arr = arr[:, 0]
    return Sample(arr, label, metadata or {"format": "csv"})


def ingest_json(path_or_bytes, metadata: Optional[Dict] = None) -> Sample:
    """Edge-Impulse-style JSON: {"values": [...], "label": int, ...}."""
    if isinstance(path_or_bytes, (str, Path)):
        obj = json.loads(Path(path_or_bytes).read_text())
    else:
        obj = json.loads(path_or_bytes)
    arr = np.asarray(obj["values"], np.float32)
    meta = {k: v for k, v in obj.items() if k not in ("values", "label")}
    meta.update(metadata or {})
    return Sample(arr, int(obj.get("label", -1)), meta)


def ingest_wav(path_or_bytes, label: int,
               metadata: Optional[Dict] = None) -> Sample:
    if isinstance(path_or_bytes, (str, Path)):
        buf = Path(path_or_bytes).read_bytes()
    else:
        buf = path_or_bytes
    with wave.open(io.BytesIO(buf)) as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        rate = w.getframerate()
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    arr = np.frombuffer(raw, dtype).astype(np.float32)
    arr /= float(np.iinfo(dtype).max)
    meta = {"sample_rate": rate, "format": "wav"}
    meta.update(metadata or {})
    return Sample(arr, label, meta)


def ingest_npy(path_or_bytes, label: int,
               metadata: Optional[Dict] = None) -> Sample:
    if isinstance(path_or_bytes, (str, Path)):
        arr = np.load(path_or_bytes)
    else:
        arr = np.load(io.BytesIO(path_or_bytes))
    return Sample(np.asarray(arr, np.float32), label,
                  metadata or {"format": "npy"})


INGESTORS = {".csv": ingest_csv, ".json": ingest_json,
             ".wav": ingest_wav, ".npy": ingest_npy}


def ingest_directory(root: Path, label_from_dir: bool = True
                     ) -> List[Sample]:
    """class-per-subdirectory layout: root/<label_idx>_<name>/file.ext"""
    out: List[Sample] = []
    root = Path(root)
    for sub in sorted(p for p in root.iterdir() if p.is_dir()):
        label = int(sub.name.split("_")[0]) if label_from_dir else -1
        for f in sorted(sub.iterdir()):
            fn = INGESTORS.get(f.suffix)
            if fn is None:
                continue
            if f.suffix == ".json":
                out.append(ingest_json(f, metadata={"path": str(f)}))
            else:
                out.append(fn(f, label, {"path": str(f)}))
    return out
