"""Foundational layers: norms, rotary embeddings, cache attention, MLP.

Plain functions on tensors, ``f(params, x, ...) -> y``, in the layouts of
``repro.models.layers``.  The two attention layers of the serving path
and the whole-sequence ``attention_layer`` of the training path go
through ``kernels.ops``: the CUDA kernels for tensors on the card, the
plain PyTorch versions on the CPU.

Unlike the JAX package, whose arrays are immutable, the cache layers
write this step's K/V rows **in place** into the cache tensors they are
given.  Those are views (one layer of the stacked cache, or one slot's
row of it), so the write lands in the big cache and nothing is copied.
A cache is float or ``Int8KV`` (the rows are quantized as they are
written), contiguous ``(B, S, Hkv, D)``, a paged pool ``(NB, BS, Hkv,
D)`` addressed through a block table, or (``window > 0``) a sliding-window
ring ``(B, window, Hkv, D)`` whose entry for position p sits at row
``p % window``.

Each of the three attention layers has a cross-attention branch (the
enc-dec decoder, ``models/encdec.py``): the keys and values are the
encoder's output projected once (``kv_override`` for a whole sequence,
the fixed ``xk``/``xv`` cache leaves for decode and chunks), every key is
visible, the query is not roped (``rope_variant="none"``, or the decode
branch, which returns before any rope) and nothing is written.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import (Int8KV, PrecisionPolicy, dequant_kv,
                                       is_int8_kv_fakequant, quant_kv)
from repro_torch.kernels.ops import (chunk_attention, decode_attention,
                                     flash_attention, quant_matmul)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequencies split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  x: (..., S, H, D); positions: (..., S, 3)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover"
                         f" head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                        # (D/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(tuple(sections), device=x.device),
        output_size=d // 2)                                       # (D/2,)
    pos = positions.float()[..., sec_ids]                         # (..., S, D/2)
    angles = (pos * freqs)[..., None, :]                          # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x, positions, rope_variant: str, rope_theta: float,
          mrope_sections=None):
    """Rotate x (..., S, H, D) by ``positions``: (..., S) for "rope";
    (..., S, 3) for "mrope", where (..., S) (the decode and chunk layers'
    text positions) stands for three equal streams."""
    if rope_variant == "mrope":
        if positions.dim() == x.dim() - 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        return apply_mrope(x, positions, rope_theta, mrope_sections)
    if rope_variant == "rope":
        return apply_rope(x, positions, rope_theta)
    if rope_variant == "none":
        return x
    raise ValueError(f"unknown rope variant {rope_variant!r}")


def position_encode(q: torch.Tensor, k: torch.Tensor,
                    positions: torch.Tensor, variant: str, theta: float,
                    sections=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated by ``positions`` under ``variant`` ("mrope", "rope"
    or "none"), as ``repro.models.layers.position_encode``."""
    return (_rope(q, positions, variant, theta, sections),
            _rope(k, positions, variant, theta, sections))


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


def write_pages(pool: torch.Tensor, new: torch.Tensor, blk: torch.Tensor,
                off: torch.Tensor, active: Optional[torch.Tensor] = None
                ) -> None:
    """In place: ``pool[blk[b, i], off[b, i]] = new[b, i]``.

    pool: (NB, BS, ...); new: (B, C, ...); blk/off: (B, C) pool addresses
    (unique among the active rows: a written block has one owner).  Rows
    with ``active[b] == False`` write nothing: each repeats the write of
    the first active row (the same address, the same value), and with no
    active row at all, row 0's address is rewritten with what it holds.
    No host sync is needed to drop them.
    """
    new = new.to(pool.dtype)
    if active is not None:
        b = active.shape[0]
        first = torch.argmax(active.to(torch.int32))
        src = torch.where(active, torch.arange(b, device=active.device),
                          first)
        blk, off, new = blk[src], off[src], new[src]
        # active.any() is active[first] without reading first on the host
        new = torch.where(active.any(), new, pool[blk, off])
    pool[blk, off] = new


def _write_kv(cache, new: torch.Tensor, write) -> None:
    """Write K or V rows ``new`` (B, C, Hkv, D) into ``cache`` in place,
    quantized per (entry, head) when the cache is ``Int8KV``.  ``write``
    is a function ``(tensor, rows) -> None`` addressing the layout."""
    if isinstance(cache, Int8KV):
        qn = quant_kv(new)
        write(cache.q, qn.q)
        write(cache.scale, qn.scale)
    else:
        write(cache, new)


def _fake_quant_kv(policy, k, v):
    """Under a fake-quant int8 policy a float cache stores the K/V rows'
    quantize-dequantize round trip, the int8 cache's numerics in float."""
    if is_int8_kv_fakequant(policy):
        return dequant_kv(quant_kv(k), k.dtype), dequant_kv(quant_kv(v),
                                                            v.dtype)
    return k, v


# ---------------------------------------------------------------------------
# Whole-sequence attention (training)
# ---------------------------------------------------------------------------
def attention_layer(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_variant: str, rope_theta: float,
                    mrope_sections=None, window: int = 0,
                    causal: bool = True, kv_override=None,
                    mask_pos: Optional[torch.Tensor] = None,
                    policy: Optional[PrecisionPolicy] = None):
    """Attention over a whole sequence (``repro.models.layers:273``).  x:
    (B, S, d); positions: (B, S), or (B, S, 3) under M-RoPE (the temporal,
    height and width streams; all three rotate q and k).

    The core is ``ops.flash_attention``.  The reference masks by position,
    by the temporal stream ``positions[..., 0]`` (``layers.py:296``,
    ``:310``).  ``mask_pos`` (B, S) int32 is that stream, given where the
    caller brought positions: the kernel takes it as both its query and
    key positions and masks by it (an image's patches share one temporal
    position; a packed row restarts and pads at −1).  Without it the
    kernel masks by index, which equals the reference's masks for the
    default positions 0..S-1, so that the default launch stays the index
    one.

    ``kv_override=(xk, xv)`` (B, S_enc, Hkv, D) is cross-attention
    (``layers.py:299-305``): the keys and values are taken as given, the
    query alone is roped (where ``rope_variant`` is not "none"; the enc-dec
    decoder passes "none"), and the core runs with ``causal=False``, S
    queries against S_enc keys, every key visible.  Returns (out (B, S,
    d), (k, v)).
    """
    b, s, _ = x.shape
    q = quant_matmul(x, p["wq"], policy=policy).reshape(
        b, s, n_heads, head_dim)
    if kv_override is None:
        k = quant_matmul(x, p["wk"], policy=policy).reshape(
            b, s, n_kv_heads, head_dim)
        v = quant_matmul(x, p["wv"], policy=policy).reshape(
            b, s, n_kv_heads, head_dim)
        q, k = position_encode(q, k, positions, rope_variant, rope_theta,
                               mrope_sections)
    else:
        k, v = kv_override
        q = _rope(q, positions, rope_variant, rope_theta, mrope_sections)
        mask_pos = None
    o = flash_attention(q, k, v, causal=causal, window=window, q_pos=mask_pos,
                        k_pos=mask_pos)
    out = quant_matmul(o.reshape(b, s, n_heads * head_dim), p["wo"],
                       policy=policy)
    return out, (k, v)


# ---------------------------------------------------------------------------
# Attention against the slot-addressed or paged KV cache
# ---------------------------------------------------------------------------
def attention_decode_layer(p: dict, x: torch.Tensor, position: torch.Tensor,
                           cache_k, cache_v, cache_positions: torch.Tensor,
                           write_idx: torch.Tensor, *, n_heads: int,
                           n_kv_heads: int, head_dim: int, rope_variant: str,
                           rope_theta: float, mrope_sections=None,
                           window: int = 0,
                           policy: Optional[PrecisionPolicy] = None,
                           kv_len: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None,
                           block_table: Optional[torch.Tensor] = None,
                           cross: bool = False) -> torch.Tensor:
    """One decode step.  x: (B, 1, d); position: (B,) absolute position
    (under M-RoPE, three equal streams: ``layers.py:386-389``); write_idx:
    (B,) cache row this token's K/V is written to.

    ``cache_k``/``cache_v`` (B, S, Hkv, D), float or ``Int8KV``, are
    written in place; ``cache_positions`` (B, S) must already carry this
    step's position stamp (``transformer.forward_decode`` writes it once
    for all layers).  ``kv_len`` (B,) bounds each row's live region by
    index; rows with ``active == False`` are not written.

    ``window > 0`` marks a sliding-window ring cache (B, window, Hkv, D):
    ``write_idx`` is then ``position % window``, and the ring bounds itself
    (its fill is a prefix of ``min(position + 1, window)`` rows; an idle
    slot's ``kv_len == 0`` still wins).

    ``block_table`` (B, n) selects the paged layout: the caches are
    (NB, BS, Hkv, D) pools, ``cache_positions`` the (NB, BS) position
    pool, and the token's row is ``(block_table[b, write_idx // BS],
    write_idx % BS)``.

    ``cross=True`` is cross-attention (``layers.py:374-381``): the caches
    hold the encoder's K/V, ``cache_positions`` its positions; the query,
    not roped, attends all of it from position 2^30 (no ``kv_len``, no
    window), and nothing is written.  Returns the layer output (B, 1, d).
    """
    b = x.shape[0]
    q = quant_matmul(x, p["wq"], policy=policy).reshape(
        b, 1, n_heads, head_dim)
    if cross:
        o = decode_attention(q, cache_k, cache_v, _far(position, (b,)),
                             cache_positions)
        return quant_matmul(o.reshape(b, 1, n_heads * head_dim), p["wo"],
                            policy=policy)
    k = quant_matmul(x, p["wk"], policy=policy).reshape(
        b, 1, n_kv_heads, head_dim)
    v = quant_matmul(x, p["wv"], policy=policy).reshape(
        b, 1, n_kv_heads, head_dim)
    q, k = position_encode(q, k, position[:, None], rope_variant,
                           rope_theta, mrope_sections)
    if not isinstance(cache_k, Int8KV):
        k, v = _fake_quant_kv(policy, k, v)
    if block_table is not None:
        bs = cache_positions.shape[1]
        blk = block_table.gather(1, (write_idx // bs)[:, None].long()).long()
        off = (write_idx % bs)[:, None].long()

        def write(t, rows):
            write_pages(t, rows, blk, off, active)
    else:
        def write(t, rows):
            write_rows(t, rows, write_idx, active)
    _write_kv(cache_k, k, write)
    _write_kv(cache_v, v, write)
    bound = kv_len
    if window > 0:
        s_kv = cache_positions.shape[1]
        bound = position.to(torch.int32).clamp(max=s_kv - 1) + 1
        if kv_len is not None:
            bound = torch.minimum(bound, kv_len.clamp(0, s_kv))
    o = decode_attention(q, cache_k, cache_v, position, cache_positions,
                         window=window, kv_len=bound,
                         block_table=block_table)
    return quant_matmul(o.reshape(b, 1, n_heads * head_dim), p["wo"],
                        policy=policy)


# the query position of a cross-attention step: past every encoder position
CROSS_QUERY_POSITION = 2 ** 30


def _far(like: torch.Tensor, shape) -> torch.Tensor:
    """int32 ``CROSS_QUERY_POSITION`` of ``shape`` on ``like``'s device."""
    return torch.full(shape, CROSS_QUERY_POSITION, dtype=torch.int32,
                      device=like.device)


def ring_scatter_idx(positions: torch.Tensor, window: int) -> torch.Tensor:
    """Ring write targets for a prefill chunk.  positions: (B, C) absolute
    chunk positions (−1 pad).  Returns (B, C) int32 indices into a
    ``window``-row ring: entry i lands at ``pos % window``; pad entries and
    entries older than the chunk's last ``window`` real tokens (which would
    collide with a newer winner of the same chunk) get ``window``, out of
    bounds, which ``ring_scatter`` drops."""
    valid = positions >= 0
    n_valid = valid.sum(dim=1, keepdim=True)
    i = torch.arange(positions.shape[1], device=positions.device)[None]
    winner = valid & (i >= n_valid - window)
    return torch.where(winner, positions % window, window).to(torch.int32)


def ring_scatter(cache: torch.Tensor, new: torch.Tensor,
                 idx: torch.Tensor) -> None:
    """In place: ``cache[b, idx[b, i]] = new[b, i]`` for every ``idx[b, i]
    < w``; entries at ``w`` (``ring_scatter_idx``'s out of bounds) are
    dropped.  cache: (B, w, ...); new: (B, C, ...).  With no host read: a
    dropped entry repeats its row's first kept write (the same address,
    the same value), and a row that keeps nothing rewrites its row 0 with
    what it holds."""
    b, c = idx.shape
    w = cache.shape[1]
    keep = idx < w
    first = torch.argmax(keep.to(torch.int32), dim=1, keepdim=True)
    src = torch.where(keep, torch.arange(c, device=idx.device)[None], first)
    bi = torch.arange(b, device=idx.device)[:, None]
    any_kept = keep.any(dim=1, keepdim=True)
    tgt = torch.where(any_kept, idx.gather(1, src).long(), 0)
    vals = new.to(cache.dtype)[bi, src]
    mask = any_kept.reshape((b, 1) + (1,) * (vals.dim() - 2))
    cache[bi, tgt] = torch.where(mask, vals, cache[bi, tgt])


def attention_chunk_layer(p: dict, x: torch.Tensor, positions: torch.Tensor,
                          cache_k, cache_v, cache_positions: torch.Tensor,
                          write_idx: torch.Tensor, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, rope_variant: str,
                          rope_theta: float, mrope_sections=None,
                          window: int = 0,
                          policy: Optional[PrecisionPolicy] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          block_table: Optional[torch.Tensor] = None,
                          cross: bool = False) -> torch.Tensor:
    """One chunk-prefill step: C tokens written unpadded into the slot's
    cache rows ``[write_idx, write_idx + C)`` first, then attending the
    slot's live prefix plus themselves.

    x: (B, C, d); positions: (B, C), −1 marking the pad tail of a ragged
    final chunk (its rows are written, stamped −1 by the caller, and its
    outputs are ignored); under M-RoPE three equal streams
    (``layers.py:542-545``).  ``kv_len`` is the post-write fill.  The K/V
    writes are in place, as in ``attention_decode_layer``, into a float
    or ``Int8KV`` cache, contiguous or (``block_table``) paged: row
    ``write_idx + i`` lands at ``(block_table[b, (write_idx + i) // BS],
    (write_idx + i) % BS)``, pad-tail rows included.

    ``window > 0`` marks a ring cache (``write_idx`` and ``kv_len`` unused):
    writing first would let the chunk's early entries overwrite ring rows
    that its later queries still see, so the chunk attends ``[ring ∥
    chunk]`` concatenated (positions out of index order; the kernel masks
    by position and window), and then the chunk's last ``window`` real
    entries are scattered into their ``pos % window`` rows.  The ring's
    positions are not written here: ``cache_positions`` is the ring's
    stamp from before the chunk, which the caller updates once after every
    layer has run.

    ``cross=True`` is cross-attention (``layers.py:524-537``): the caches
    hold the encoder's K/V, ``cache_positions`` its positions, and nothing
    is written.  The query is roped only where ``rope_variant`` is not
    "none" (the enc-dec decoder passes "none"); every real query attends
    all of the encoder from position 2^30, and a pad query (position −1)
    attends nothing, so its row comes out exactly zero.  Returns (B, C, d).
    """
    b, c, _ = x.shape
    q = quant_matmul(x, p["wq"], policy=policy).reshape(
        b, c, n_heads, head_dim)
    if cross:
        q = _rope(q, positions, rope_variant, rope_theta, mrope_sections)
        q_valid = torch.where(positions >= 0, _far(positions, positions.shape),
                              -1)
        o = chunk_attention(q, cache_k, cache_v, q_valid, cache_positions)
        return quant_matmul(o.reshape(b, c, n_heads * head_dim), p["wo"],
                            policy=policy)
    k = quant_matmul(x, p["wk"], policy=policy).reshape(
        b, c, n_kv_heads, head_dim)
    v = quant_matmul(x, p["wv"], policy=policy).reshape(
        b, c, n_kv_heads, head_dim)
    q, k = position_encode(q, k, positions, rope_variant, rope_theta,
                           mrope_sections)
    if not isinstance(cache_k, Int8KV):
        k, v = _fake_quant_kv(policy, k, v)
    if window > 0:
        o = _ring_chunk(q, k, v, cache_k, cache_v, positions,
                        cache_positions, window)
        return quant_matmul(o.reshape(b, c, n_heads * head_dim), p["wo"],
                            policy=policy)
    if block_table is not None:
        bs = cache_positions.shape[1]
        tgt = (write_idx[:, None]
               + torch.arange(c, device=x.device)[None]).long()
        blk = block_table.gather(1, tgt // bs).long()
        off = tgt % bs

        def write(t, rows):
            write_pages(t, rows, blk, off)
        bound = kv_len
    else:
        def write(t, rows):
            write_rows(t, rows, write_idx)
        s_kv = cache_positions.shape[1]
        bound = None if kv_len is None else kv_len.clamp(0, s_kv)
    _write_kv(cache_k, k, write)
    _write_kv(cache_v, v, write)
    o = chunk_attention(q, cache_k, cache_v, positions, cache_positions,
                        kv_len=bound, block_table=block_table)
    return quant_matmul(o.reshape(b, c, n_heads * head_dim), p["wo"],
                        policy=policy)


def _ring_chunk(q, k, v, cache_k, cache_v, positions, ring_positions,
                window: int) -> torch.Tensor:
    """The ring branch of ``attention_chunk_layer``: attend ``[ring ∥
    chunk]``, then scatter the winners into the ring (values and, for an
    ``Int8KV`` ring, scales)."""
    if isinstance(cache_k, Int8KV):
        qk, qv = quant_kv(k), quant_kv(v)
        k_all = Int8KV(torch.cat([cache_k.q, qk.q], dim=1),
                       torch.cat([cache_k.scale, qk.scale], dim=1))
        v_all = Int8KV(torch.cat([cache_v.q, qv.q], dim=1),
                       torch.cat([cache_v.scale, qv.scale], dim=1))
        pairs = ((cache_k.q, qk.q), (cache_k.scale, qk.scale),
                 (cache_v.q, qv.q), (cache_v.scale, qv.scale))
    else:
        k_all = torch.cat([cache_k, k.to(cache_k.dtype)], dim=1)
        v_all = torch.cat([cache_v, v.to(cache_v.dtype)], dim=1)
        pairs = ((cache_k, k), (cache_v, v))
    pos_all = torch.cat([ring_positions, positions.to(ring_positions.dtype)],
                        dim=1)
    o = chunk_attention(q, k_all, v_all, positions, pos_all, window=window)
    idx = ring_scatter_idx(positions, window)
    for ring, new in pairs:
        ring_scatter(ring, new, idx)
    return o


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def swiglu_mlp(p: dict, x: torch.Tensor,
               policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    gate = quant_matmul(x, p["w_gate"], policy=policy)
    up = quant_matmul(x, p["w_up"], policy=policy)
    return quant_matmul(F.silu(gate) * up, p["w_down"], policy=policy)
