"""Foundational layers: norms, rotary embeddings, cache attention, MLP.

Plain functions on tensors, ``f(params, x, ...) -> y``, in the layouts of
``repro.models.layers``.  The two attention layers of the serving path
go through ``kernels.ops``: the CUDA kernels for tensors on the card,
the plain PyTorch versions on the CPU.

Unlike the JAX package, whose arrays are immutable, the cache layers
write this step's K/V rows **in place** into the cache tensors they are
given.  Those are views (one layer of the stacked cache, or one slot's
row of it), so the write lands in the big cache and nothing is copied.
This slice ports the contiguous, non-ring, non-cross branches.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (chunk_attention, decode_attention,
                                     quant_matmul)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Standard RoPE. x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    angles = angles[..., None, :]                                 # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_qk(q, k, positions, rope_variant: str, rope_theta: float):
    if rope_variant == "rope":
        return apply_rope(q, positions, rope_theta), \
            apply_rope(k, positions, rope_theta)
    if rope_variant == "none":
        return q, k
    raise NotImplementedError(
        f"rope variant {rope_variant!r} is not ported yet")


# ---------------------------------------------------------------------------
# In-place cache writes
# ---------------------------------------------------------------------------
def write_rows(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> None:
    """In place: ``cache[b, start[b] + i] = new[b, i]`` for ``i < C``.

    cache: (B, S, ...); new: (B, C, ...); start: (B,).  The start is
    clamped to ``[0, S - C]``, as ``lax.dynamic_update_slice`` clamps it.
    Rows with ``active[b] == False`` keep their entries (an idle or
    mid-prefill slot in a decode batch is never written).
    """
    b, c = new.shape[:2]
    start = start.clamp(0, cache.shape[1] - c)
    rows = start[:, None] + torch.arange(c, device=cache.device)    # (B, C)
    bi = torch.arange(b, device=cache.device)[:, None]
    new = new.to(cache.dtype)
    if active is not None:
        keep = active.reshape((b,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, cache[bi, rows])
    cache[bi, rows] = new


# ---------------------------------------------------------------------------
# Attention against the slot-addressed KV cache
# ---------------------------------------------------------------------------
def attention_decode_layer(p: dict, x: torch.Tensor, position: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           cache_positions: torch.Tensor,
                           write_idx: torch.Tensor, *, n_heads: int,
                           n_kv_heads: int, head_dim: int, rope_variant: str,
                           rope_theta: float,
                           kv_len: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One decode step.  x: (B, 1, d); position: (B,) absolute position;
    write_idx: (B,) cache row this token's K/V is written to.

    ``cache_k``/``cache_v`` (B, S, Hkv, D) are written in place;
    ``cache_positions`` (B, S) must already carry this step's position
    stamp (``transformer.forward_decode`` writes it once for all layers).
    ``kv_len`` (B,) bounds each row's live region by index; rows with
    ``active == False`` are not written.  Returns the layer output
    (B, 1, d).
    """
    b = x.shape[0]
    q = quant_matmul(x, p["wq"]).reshape(b, 1, n_heads, head_dim)
    k = quant_matmul(x, p["wk"]).reshape(b, 1, n_kv_heads, head_dim)
    v = quant_matmul(x, p["wv"]).reshape(b, 1, n_kv_heads, head_dim)
    q, k = _rope_qk(q, k, position[:, None], rope_variant, rope_theta)
    write_rows(cache_k, k, write_idx, active)
    write_rows(cache_v, v, write_idx, active)
    o = decode_attention(q, cache_k, cache_v, position, cache_positions,
                         kv_len=kv_len)
    return quant_matmul(o.reshape(b, 1, n_heads * head_dim), p["wo"])


def attention_chunk_layer(p: dict, x: torch.Tensor, positions: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          cache_positions: torch.Tensor,
                          write_idx: torch.Tensor, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, rope_variant: str,
                          rope_theta: float,
                          kv_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One chunk-prefill step: C tokens written unpadded into the slot's
    cache rows ``[write_idx, write_idx + C)`` first, then attending the
    slot's live prefix plus themselves.

    x: (B, C, d); positions: (B, C), −1 marking the pad tail of a ragged
    final chunk (its rows are written, stamped −1 by the caller, and its
    outputs are ignored).  ``kv_len`` is the post-write fill.  The K/V
    writes are in place, as in ``attention_decode_layer``.  Returns
    (B, C, d).
    """
    b, c, _ = x.shape
    q = quant_matmul(x, p["wq"]).reshape(b, c, n_heads, head_dim)
    k = quant_matmul(x, p["wk"]).reshape(b, c, n_kv_heads, head_dim)
    v = quant_matmul(x, p["wv"]).reshape(b, c, n_kv_heads, head_dim)
    q, k = _rope_qk(q, k, positions, rope_variant, rope_theta)
    write_rows(cache_k, k, write_idx)
    write_rows(cache_v, v, write_idx)
    s_kv = cache_positions.shape[1]
    bound = None if kv_len is None else kv_len.clamp(0, s_kv)
    o = chunk_attention(q, cache_k, cache_v, positions, cache_positions,
                        kv_len=bound)
    return quant_matmul(o.reshape(b, c, n_heads * head_dim), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = quant_matmul(x, p["w_gate"])
    up = quant_matmul(x, p["w_up"])
    return quant_matmul(F.silu(gate) * up, p["w_down"])
