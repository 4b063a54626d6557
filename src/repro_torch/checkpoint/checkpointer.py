"""Atomic, versioned checkpointing: the counterpart of
``repro.checkpoint.checkpointer``, with restore onto another mesh.

Layout: ``<root>/step_<N>/`` holds one ``.npy`` per leaf and a manifest
(``manifest.json``) of each leaf's file, shape and dtype.  Leaves are
named by their path in the tree (``0/blocks/attn/wq``: tuple index, then
dict keys in sorted order), as the JAX package names them.  Writes are
atomic (a temp dir, the manifest written last, a rename), so a killed
writer never leaves a readable but wrong checkpoint.  ``restore`` copies
the saved values **in place** into the tensors of the tree it is given
(a ``ParamTree``, the optimizer state, tuples of them) and returns it.

``restore`` also reads the reference's sharded record, ``{"shape",
"dtype", "shards": [{"file", "index"}]}``, which a job on many devices
writes: each leaf is reassembled from its shards by their index slices.
Given ``shardings`` (a tree of ``sharding.policy.NamedSharding`` matching
the tree, as ``launch/elastic.py::elastic_restore`` makes it), each
leaf is placed on its sharding's device (a mesh of one device) in a new
tree, so a checkpoint that a job on a pod wrote restores on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import as_tree


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        t = as_tree(t)
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + [str(k)])
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, path + [str(i)])
        else:
            out.append(("/".join(path), t))
    walk(tree, [])
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The leaf's bytes as numpy (bf16 as its int16 bits) and its dtype."""
    t = t.detach().cpu()
    dtype = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class Checkpointer:
    def __init__(self, root: Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> Path:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                    "leaves": {}, "extra": extra or {}}
        for key, leaf in _leaf_paths(tree):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"checkpoint leaf {key} is a"
                                f" {type(leaf).__name__}, not a tensor")
            arr, dtype = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": dtype}
        # the manifest last, then the atomic rename
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if (p / "manifest.json").exists():   # incomplete = invisible
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, tree_like, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, Dict]:
        """Checkpoint ``step`` (default: the latest) into ``tree_like``;
        returns (the tree, extra).  Without ``shardings`` the values are
        copied into ``tree_like``'s tensors in place; with them, each leaf
        is a new tensor on its sharding's device, in a nested dict of
        ``tree_like``'s structure (whose leaves may then be ``meta``
        tensors: shapes and dtypes only).  Raises on a leaf that is
        missing or of another shape or dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.root}")
        cdir = self.root / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        placed = dict(_leaf_paths(shardings)) if shardings is not None \
            else None
        out: Dict[str, torch.Tensor] = {}
        for key, ref in _leaf_paths(tree_like):
            rec = manifest["leaves"].get(key)
            want = str(ref.dtype).replace("torch.", "")
            if rec is None or tuple(rec["shape"]) != tuple(ref.shape) \
                    or rec["dtype"] != want:
                raise ValueError(f"checkpoint step {step} leaf {key}: {rec}"
                                 f" does not fit {tuple(ref.shape)} {want}")
            value = _from_numpy(_assemble(cdir, rec), rec["dtype"])
            if placed is None:
                ref.copy_(value)
            else:
                out[key] = value.to(placed[key].device)
        if placed is None:
            return tree_like, manifest["extra"]
        return _rebuild(tree_like, out), manifest["extra"]


def _assemble(cdir: Path, rec: Dict[str, Any]) -> np.ndarray:
    """A leaf's array: the port's one file, or the reference's shards put
    together by their index slices (``[start, stop, step]`` a dim)."""
    if "shards" not in rec:
        return np.load(cdir / rec["file"])
    shards = rec["shards"]
    if shards[0]["index"] is None:
        return _raw(np.load(cdir / shards[0]["file"]), rec["dtype"])
    full = None
    for srec in shards:
        piece = _raw(np.load(cdir / srec["file"]), rec["dtype"])
        if full is None:
            full = np.zeros(rec["shape"], dtype=piece.dtype)
        full[tuple(slice(a, b, c) for a, b, c in srec["index"])] = piece
    return full


def _raw(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A bf16 leaf's bits as int16 (numpy has no bfloat16: the reference's
    file holds it as an extension dtype or two raw bytes an element)."""
    return arr.view(np.int16) if dtype == "bfloat16" else arr


def _rebuild(tree_like, values: Dict[str, torch.Tensor], path=()):
    """``tree_like``'s structure (dicts, lists, tuples) with the leaf at
    each path taken from ``values``."""
    t = as_tree(tree_like)
    if isinstance(t, dict):
        return {k: _rebuild(t[k], values, path + (str(k),)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(x, values, path + (str(i),))
                       for i, x in enumerate(t))
    return values["/".join(path)]
