"""Gradient compression with error feedback: the counterpart of
``repro.train.compression``.

Two schemes, each carrying the compression error to the next step in a
residual so it does not bias the trajectory:

* int8: per-leaf symmetric int8 quantization (8x fewer wire bytes than
  f32);
* topk: keep the largest-|g| fraction of each leaf.

On one device nothing goes over a wire: the numerics are those of the
deployed scheme, which is what training-quality experiments need.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.tree import as_tree, map_tree


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: scale max|g| / 127 (floored at 1e-12 / 127),
    round half to even, clip to [-127, 127]."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / torch.tensor(
        127.0, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where |g| is at least the k-th largest |g|, k = max(int(size *
    frac), 1); ties at the threshold are kept."""
    k = max(int(g.numel() * frac), 1)
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compress_grads(grads, residual, scheme: Optional[str],
                   topk_frac: float = 0.01):
    """Compress each leaf of ``grads`` plus its residual; returns
    (compressed grads, new residual), trees of ``grads``' structure."""
    if scheme is None or scheme == "none":
        return grads, residual
    if scheme not in ("int8", "topk"):
        raise ValueError(scheme)

    def one(g, r):
        g = g.float() + (r if r is not None else 0.0)
        if scheme == "int8":
            out = int8_decompress(*int8_compress(g))
        else:
            out = g * topk_mask(g, topk_frac)
        return out, g - out

    if residual is None:
        residual = init_residual(grads)
    pairs = map_tree(one, grads, residual)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(pairs, i: int):
    """Element ``i`` of each (compressed, residual) pair of a dict tree."""
    if isinstance(pairs, dict):
        return {k: _pick(v, i) for k, v in pairs.items()}
    return pairs[i]


def init_residual(params):
    """Zero f32 residuals of each leaf's shape."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), as_tree(params))
