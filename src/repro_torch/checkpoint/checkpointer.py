"""Atomic, versioned checkpointing on one device: the counterpart of
``repro.checkpoint.checkpointer`` (resharding onto another mesh comes
with the sharding slice).

Layout: ``<root>/step_<N>/`` holds one ``.npy`` per leaf and a manifest
(``manifest.json``) of each leaf's file, shape and dtype.  Leaves are
named by their path in the tree (``0/blocks/attn/wq``: tuple index, then
dict keys in sorted order), as the JAX package names them.  Writes are
atomic (a temp dir, the manifest written last, a rename), so a killed
writer never leaves a readable but wrong checkpoint.  ``restore`` copies
the saved values **in place** into the tensors of the tree it is given
(a ``ParamTree``, the optimizer state, tuples of them) and returns it.
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
    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Copy checkpoint ``step`` (default: the latest) into the tensors
        of ``tree_like`` in place; returns (tree_like, extra).  Raises on
        a leaf that is missing or of another shape or dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.root}")
        cdir = self.root / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        for key, ref in _leaf_paths(tree_like):
            rec = manifest["leaves"].get(key)
            want = str(ref.dtype).replace("torch.", "")
            if rec is None or tuple(rec["shape"]) != tuple(ref.shape) \
                    or rec["dtype"] != want:
                raise ValueError(f"checkpoint step {step} leaf {key}: {rec}"
                                 f" does not fit {tuple(ref.shape)} {want}")
            ref.copy_(_from_numpy(np.load(cdir / rec["file"]), rec["dtype"]))
        return tree_like, manifest["extra"]
