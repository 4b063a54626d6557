"""Dispatch wrappers: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The model layers call these.  Which path runs follows from where the
tensor lies and from nothing else: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes ``kernels/ref.py``.  There is no
fallback and no switch.

``quant_matmul`` is the matmul every projection goes through.  On this
slice it is the float path, ``x @ w``, left to ``torch.matmul`` as the
JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for a tensor on {x.device}")


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` for a float weight.  Quantized (``QTensor``)
    weights come with the int8 port slice."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quant_matmul on {type(w).__name__} weights: int8 serving comes"
            " with port slice 2")
    return x @ w.to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_position: torch.Tensor,
                     cache_positions: torch.Tensor, *, window: int = 0,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode attention against a slot-addressed KV cache.

    q: (B, 1, Hq, D); k/v caches: (B, S, Hkv, D); q_position: (B,);
    cache_positions: (B, S), −1 marking invalid entries.  ``kv_len`` (B,)
    is the per-slot fill: entries at index >= kv_len are not read (None
    reads all S).
    """
    if not _on_card(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, q_position,
                                        cache_positions, window=window,
                                        kv_len=kv_len)
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), k_cache.shape[1], dtype=torch.int32,
                            device=q.device)
    out = fd.flash_decode(
        q.reshape(b, hkv, hq // hkv, d).contiguous(), k_cache, v_cache,
        q_position.to(torch.int32).contiguous(), cache_positions,
        kv_len.to(torch.int32).contiguous(), window=window)
    return out.reshape(b, 1, hq, d)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_positions: torch.Tensor,
                    cache_positions: torch.Tensor, *, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunk-prefill attention: C queries per slot against its cache.

    q: (B, C, Hq, D); q_positions: (B, C), −1 marking pad queries (exact
    zeros out); the rest as in ``decode_attention``.  The chunk's own K/V
    must already be in the cache; ``kv_len`` is the post-write fill.
    """
    if not _on_card(q):
        return ref.chunk_attention_ref(q, k_cache, v_cache, q_positions,
                                       cache_positions, window=window,
                                       kv_len=kv_len)
    b, c, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    if kv_len is None:
        kv_len = torch.full((b,), k_cache.shape[1], dtype=torch.int32,
                            device=q.device)
    # grouped rows ordered (query, group): row c*G + g shares KV head h
    qg = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, c * g, d).contiguous()
    qp_rows = q_positions.to(torch.int32)[:, :, None].expand(b, c, g) \
        .reshape(b, c * g).contiguous()
    out = fd.flash_chunk_prefill(qg, k_cache, v_cache, qp_rows,
                                 cache_positions,
                                 kv_len.to(torch.int32).contiguous(),
                                 window=window)
    return out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, hq, d)
