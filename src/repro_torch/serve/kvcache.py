"""KV-cache utilities: sizing arithmetic and the slot API the
continuous-batching engine is built on.

The counterpart of ``repro.serve.kvcache`` on this slice (contiguous
float cache):

* ``kv_cache_bytes``      — footprint arithmetic.
* ``alloc_decode_cache``  — zero-filled ``slots`` x ``capacity`` decode
                            cache, positions −1 (invalid), built directly
                            from the config's shapes.
* ``take_slot`` / ``put_slot`` / ``release_slot`` — the slot API.  Where the
  JAX package slices and splices immutable arrays, ``take_slot`` returns
  **views** of one slot's row, so a chunk step run on them writes straight
  into the big cache; ``put_slot`` copies a batch-1 cache into a row (the
  admission reset) and ``release_slot`` invalidates a row's positions, both
  in place.
* ``decode_cache_nbytes`` — device bytes of a cache.

Validity is decided by stored positions (−1 = empty) plus the scheduler's
per-slot ``kv_len`` bound, so a row is recycled without touching its K/V.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.models.params import layer_pattern

Cache = Dict[str, torch.Tensor]

# slot (batch) axis of each leaf of the uniform dense decode cache
SLOT_AXES = {"k": 1, "v": 1, "full_pos": 0}


def kv_cache_bytes(cfg: ArchConfig, batch: int, seq_len: int,
                   dtype_bytes: int = 2, *,
                   precision: str = "float") -> int:
    """Global KV/state cache footprint for one decode session.

    ``precision="int8"`` prices the Int8KV layout: 1 byte per value plus
    one f32 scale per (entry, head) vector of ``head_dim`` values —
    attention KV only; SSM recurrent state stays float either way.
    """
    hd = cfg.resolved_head_dim
    # bytes per stored attention-KV scalar; the int8 layout adds one f32
    # scale per head-vector of hd values.  SSM conv/recurrent state stays
    # float under every precision.
    kv_bytes = (hd + 4) / hd if precision == "int8" else dtype_bytes
    if cfg.family == "ssm":
        conv = batch * (cfg.d_conv - 1) * cfg.d_inner * dtype_bytes
        h = batch * cfg.d_inner * cfg.ssm_state * 4
        return int(cfg.n_layers * (conv + h))
    if cfg.family == "hybrid":
        nh = cfg.resolved_ssm_heads
        hp = cfg.d_inner // nh
        conv = batch * (cfg.d_conv - 1) * cfg.d_inner * dtype_bytes
        h = batch * nh * hp * cfg.ssm_state * 4
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        kv = n_attn * 2 * batch * seq_len * cfg.n_kv_heads * hd * kv_bytes
        return int(cfg.n_layers * (conv + h) + kv)
    per_layer_kv = 2 * batch * cfg.n_kv_heads * hd * kv_bytes
    if cfg.sliding_window and cfg.local_global_ratio:
        r = cfg.local_global_ratio
        n_global = cfg.n_layers // (r + 1)
        n_local = cfg.n_layers - n_global
        return int(n_global * per_layer_kv * seq_len
                   + n_local * per_layer_kv * min(cfg.sliding_window, seq_len))
    # Enc-dec: encoder layers hold no decode-time cache (the encoder runs
    # once; its output *is* the cross KV).  The decoder holds self-attn KV
    # over seq_len plus cross-attn KV over the subsampled encoder length.
    total = cfg.n_layers * per_layer_kv * seq_len
    if cfg.is_encdec:
        total += cfg.n_layers * per_layer_kv * (seq_len // cfg.enc_seq_divisor)
    return int(total)


# ---------------------------------------------------------------------------
# Slot-addressed decode cache (continuous batching)
# ---------------------------------------------------------------------------
def alloc_decode_cache(cfg: ArchConfig, slots: int, capacity: int,
                       device: Union[str, torch.device, None] = None
                       ) -> Cache:
    """All-empty decode cache on ``device`` (``cuda`` unless named): K/V
    zeros (L, slots, capacity, Hkv, D) in the activation dtype, positions
    (slots, capacity) int32 at −1."""
    kind = layer_pattern(cfg)["kind"]
    if kind != "uniform_dense":
        raise NotImplementedError(
            f"{cfg.name}: decode cache of layer pattern {kind!r} is not"
            " ported yet")
    device = resolve_device(device)
    kv_shape = (cfg.n_layers, slots, capacity, cfg.n_kv_heads,
                cfg.resolved_head_dim)
    return {
        "k": torch.zeros(kv_shape, dtype=cfg.activation_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.activation_dtype, device=device),
        "full_pos": torch.full((slots, capacity), -1, dtype=torch.int32,
                               device=device),
    }


def decode_cache_nbytes(cache: Cache) -> int:
    """Device bytes of a decode cache: K/V values and position leaves."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def _row(t: torch.Tensor, axis: int, slot: int) -> torch.Tensor:
    return t.narrow(axis, slot, 1)


def take_slot(big_cache: Cache, slot: int) -> Cache:
    """Slot ``slot``'s row of the big cache as a batch-1 cache of **views**:
    writes to it land in the big cache."""
    return {key: _row(t, SLOT_AXES[key], slot) for key, t in big_cache.items()}


def put_slot(big_cache: Cache, small_cache: Cache, slot: int) -> Cache:
    """Copy a batch-1 cache into row ``slot``, in place.  Putting a fresh
    ``alloc_decode_cache(cfg, 1, ...)`` resets the slot for admission."""
    for key, t in big_cache.items():
        _row(t, SLOT_AXES[key], slot).copy_(small_cache[key])
    return big_cache


def release_slot(big_cache: Cache, slot: int) -> Cache:
    """Invalidate a slot row in place: its positions become −1.  K/V bytes
    stay; no position marks them, so they are never attended."""
    for key, t in big_cache.items():
        if key.endswith("_pos"):
            t[slot].fill_(-1)
    return big_cache
