"""int8 x int8 matmul with the dequant fused into its epilogue: the
wrapper of the hand-written CUDA kernel in ``csrc/int8_matmul.cu``.

``int8_matmul`` replaces ``repro/kernels/int8_matmul.py:45``.  The
wrapper checks device, dtypes, shapes, strides and alignment, launches
the kernel on PyTorch's current stream and counts the launch in
``LAUNCHES``.  It takes CUDA tensors only: ``kernels/ops.py`` sends CPU
tensors to ``kernels/ref.py::int8_matmul_ref``.

Layout: the weight is ``(N, K)``, output channel first (the port's
``QTensor`` layout), so both operands have the contraction axis
contiguous.  Ragged M, N and K are handled inside the kernel by
predicated loads; nothing is padded or copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"int8_matmul": 0}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])


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
    vec = int(k % 16 == 0 and x_q.stride(0) % 16 == 0
              and w_q.stride(0) % 16 == 0 and x_q.data_ptr() % 16 == 0
              and w_q.data_ptr() % 16 == 0)
    rc = _lib().int8_matmul(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, n, k, x_q.stride(0),
        w_q.stride(0), vec, torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error"
                           f" {rc}")
    LAUNCHES["int8_matmul"] += 1
    return out
