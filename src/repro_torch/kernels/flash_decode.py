"""Flash-decode and chunk-prefill attention over the slot-addressed KV
cache: wrappers of the hand-written CUDA kernels in
``csrc/flash_decode.cu``.

``flash_decode`` replaces ``repro/kernels/flash_decode.py:147`` and
``flash_chunk_prefill`` replaces ``:334``, on the contiguous float
layout.  Each wrapper checks device, dtype, shape and strides, launches
its kernel on PyTorch's current stream and counts the launch in
``LAUNCHES``.  They take CUDA tensors only: ``kernels/ops.py`` sends CPU
tensors to the plain versions in ``kernels/ref.py``.

K/V may be per-layer slices of the stacked ``(L, B, S, Hkv, D)`` cache or
one slot's row of it: any batch stride is taken, the ``(S, Hkv, D)``
inner layout must be dense.  Nothing here copies the cache.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of each kernel since the last reset (the caller resets)
LAUNCHES = {"flash_decode": 0, "flash_chunk_prefill": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])


def kv_block_size(capacity: int, block_k: int = 128) -> int:
    """KV block granularity at a given per-slot capacity: the TPU kernels'
    tile choice, min(block_k, capacity), halved until it divides capacity
    cleanly (floored at 8).  Shared with the JAX package's serving engines
    (capacity rounding, the paged pool's block size), so it is kept
    identical here."""
    bk = min(block_k, max(int(capacity), 1))
    while capacity % bk and bk > 8:
        bk //= 2
    return bk


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_decode")
    if lib.flash_decode.argtypes is None:
        for fn in (lib.flash_decode, lib.flash_chunk_prefill):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, q_pos, cache_pos, kv_len, q_pos_shape):
    b, hkv, r, d = q.shape
    s = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos),
                    ("cache_pos", cache_pos), ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                        "expected one of float32, bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, s, hkv, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, s, hkv, d)}")
        if t.stride()[1:] != (hkv * d, d, 1):
            raise ValueError(f"{name} strides {t.stride()}: the (S, Hkv, D)"
                             " inner layout must be dense")
        if t.stride(0) % vec or t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned per slot")
    for name, t, shape in (("q_pos", q_pos, q_pos_shape),
                           ("kv_len", kv_len, (b,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}")
    if cache_pos.dtype != torch.int32 or tuple(cache_pos.shape) != (b, s) \
            or cache_pos.stride(1) != 1:
        raise ValueError(f"cache_pos must be int32 {(b, s)} with unit"
                         " stride along S")


def _launch(entry: str, q, k, v, q_pos, cache_pos, kv_len, window: int):
    b, hkv, r, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = getattr(_lib(), entry)
    rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_pos.data_ptr(), cache_pos.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, k.shape[1], hkv, r, d, k.stride(0),
            v.stride(0), cache_pos.stride(0), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, cache_pos: torch.Tensor,
                 kv_len: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """One-token GQA decode attention on the card.

    q: (B, Hkv, G, D) grouped queries; k/v: (B, S, Hkv, D); q_pos: (B,)
    int32; cache_pos: (B, S) int32 stored positions (−1 invalid); kv_len:
    (B,) int32 per-slot fill (S scans everything).  Returns (B, Hkv, G, D)
    in q.dtype; a slot with kv_len 0 gives exact zeros.
    """
    _check(q, k, v, q_pos, cache_pos, kv_len, (q.shape[0],))
    return _launch("flash_decode", q, k, v, q_pos, cache_pos, kv_len, window)


def flash_chunk_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, cache_pos: torch.Tensor,
                        kv_len: torch.Tensor, *, window: int = 0
                        ) -> torch.Tensor:
    """Chunk-prefill attention on the card.

    q: (B, Hkv, R, D) with R = C·G rows ordered (query, group); q_pos:
    (B, R) int32 per-row positions, −1 for a pad row (exact zeros); the
    rest as in ``flash_decode``.  The chunk's own K/V must already be in
    the cache: in-chunk causality is ``pos <= q_pos``.
    """
    _check(q, k, v, q_pos, cache_pos, kv_len, (q.shape[0], q.shape[2]))
    return _launch("flash_chunk_prefill", q, k, v, q_pos, cache_pos, kv_len,
                   window)
