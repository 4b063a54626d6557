"""int8 x int8 matmul with the dequant fused into its epilogue: the
wrapper of the hand-written CUDA kernel in ``csrc/int8_matmul.cu``.

``int8_matmul`` replaces ``repro/kernels/int8_matmul.py:45``.  The
wrapper checks device, dtypes, shapes, strides and alignment, plans the
launch from the shape (``_plan``), launches the kernel on PyTorch's
current stream and counts the launch in ``LAUNCHES``.  It takes CUDA
tensors only: ``kernels/ops.py`` sends CPU tensors to
``kernels/ref.py::int8_matmul_ref``.

Layout: the weight is ``(N, K)``, output channel first (the port's
``QTensor`` layout), so both operands have the contraction axis
contiguous.  Ragged M, N and K are handled inside the kernel by
predicated loads; nothing is padded or copied.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"int8_matmul": 0}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])

# the kernel's constants (csrc/int8_matmul.cu): bytes of K a stage holds
# of each row, channels a tile holds, the ring's depth, the portable
# cluster size and the shared memory's alignment slack
BK = 128
BN = 32
STAGES = 6
MAX_SPLIT = 8
SMEM_SLACK = 1024
SMS = 132                 # the H100's SMs
DECODE_MAX_M = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``regime`` "decode" (M <= 16) or "chunk"; a block tile
    of ``mt`` tokens x ``bn`` channels; K split over the ``split`` blocks
    of a cluster, ``kchunk`` bytes each (the last one's range ends at K);
    the grid (split, N tiles, M tiles) and the dynamic shared memory in
    bytes."""
    regime: str
    mt: int
    bn: int
    split: int
    kchunk: int
    grid: Tuple[int, int, int]
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _plan(m: int, n: int, k: int) -> Plan:
    """The launch for an (m, k) x (n, k) product, from the shape alone.
    Decode (m <= 16) takes 8 or 16 tokens a tile, a chunk 64; both 32
    channels.  K is split, in whole K tiles, until the grid holds 1.5
    blocks an SM or the split reaches the cluster limit or the K tiles
    run out; the split is then the fewest blocks that cover the K tiles
    at that many tiles a block, so no block's range is empty.  Where that
    rounding leaves SMs without a block (K 1,024 into N 1,024: 8 K tiles
    in 4 blocks of 2, 128 blocks), a block takes fewer K tiles while the
    split stays within the cluster and the wave.  A split grid stays below
    3 * SMS blocks: one wave of either kernel, whose clusters the card
    holds at 3 (chunk) or 7 (decode) blocks an SM."""
    decode = m <= DECODE_MAX_M
    mt = 8 if m <= 8 else 16 if decode else 64
    mtiles, nkt = _cdiv(m, mt), _cdiv(k, BK)
    tiles = _cdiv(n, BN) * mtiles
    split = min(MAX_SPLIT, nkt, _cdiv(3 * SMS, 2 * tiles))
    per = _cdiv(nkt, split)
    while (per > 1 and _cdiv(nkt, per) * tiles < SMS
           and _cdiv(nkt, per - 1) <= MAX_SPLIT
           and _cdiv(nkt, per - 1) * tiles < 3 * SMS):
        per -= 1
    split = _cdiv(nkt, per)
    return Plan("decode" if decode else "chunk", mt, BN, split, per * BK,
                (split, _cdiv(n, BN), mtiles),
                STAGES * (BN + mt) * BK + SMEM_SLACK)


def reset_launches() -> None:
    LAUNCHES["int8_matmul"] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_matmul")
    if lib.int8_matmul.argtypes is None:
        lib.int8_matmul.argtypes = _ARGTYPES
        lib.int8_matmul.restype = ctypes.c_int
    return lib


def _check(x_q, w_q, x_scale, w_scale):
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for name, t in (("w_q", w_q), ("x_scale", x_scale),
                    ("w_scale", w_scale)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x_q on {dev}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q/w_q dtypes {x_q.dtype}/{w_q.dtype}: expected"
                        " int8")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q {tuple(w_q.shape)}"
                         ": expected (M, K) and (N, K)")
    m, k = x_q.shape
    n = w_q.shape[0]
    if k < 1:
        raise ValueError("K must be at least 1")
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.stride(1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: K must be"
                             " contiguous")
    for name, t, size in (("x_scale", x_scale, m), ("w_scale", w_scale, n)):
        if t.dtype != torch.float32 or tuple(t.shape) != (size,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({size},)")


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (N, K) int8; x_scale: (M,) f32 per row;
    w_scale: (N,) f32 per output channel.  Returns (M, N) f32,
    ``float(acc) * (x_scale[m] * w_scale[n])`` with the exact int32 dot
    product ``acc``: bitwise equal to ``ref.int8_matmul_ref``."""
    _check(x_q, w_q, x_scale, w_scale)
    m, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    p = _plan(m, n, k)
    vec = int(k % 16 == 0 and x_q.stride(0) % 16 == 0
              and w_q.stride(0) % 16 == 0 and x_q.data_ptr() % 16 == 0
              and w_q.data_ptr() % 16 == 0)
    rc = _lib().int8_matmul(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, n, k, x_q.stride(0),
        w_q.stride(0), vec, p.mt, p.split, p.kchunk,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error"
                           f" {rc}")
    LAUNCHES["int8_matmul"] += 1
    return out
