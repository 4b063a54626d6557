"""Whole-sequence flash attention, forward and backward: wrappers of the
hand-written CUDA kernels in ``csrc/flash_attention.cu``.

``flash_attention_fwd`` replaces ``repro/kernels/flash_attention.py:83``
(causal, sliding-window or full attention with online softmax);
``flash_attention_bwd`` is the gradient the TPU kernel never had (the JAX
package lets XLA differentiate its jnp attention).  ``kernels/ops.py``
registers the two as the operators ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd`` and ties them together with
``register_autograd``: the forward saves q, k, v, the output and the
rows' log-sum-exp, the backward launches the gradient kernel on them.

Layouts are the model's: q ``(B, Sq, Hq, D)``, k/v ``(B, Skv, Hkv, D)``,
with query head ``h`` reading KV head ``h // (Hq // Hkv)`` in place, so
GQA needs no repeat copy.  Masks are by index (query row i, key j), which
equals the reference's position masks for the default positions 0..S-1.
Any Sq and Skv are taken; Skv may differ from Sq only with
``causal=False`` and ``window == 0`` (cross-attention, every key
visible).  Given per-row positions ``q_pos`` (B, Sq) and ``k_pos`` (B,
Skv) int32, the kernels mask by position instead, as the reference's
``full_attention`` does (``repro/models/layers.py:150``): key j visible
to row i when ``k_pos[j] >= 0``, ``k_pos[j] <= q_pos[i]`` (causal) and
``k_pos[j] > q_pos[i] - window``, for any Sq and Skv; a row that sees no
key (a pad query at −1) gets the mean of V over all keys and an lse near
−1e30, the reference's finite mask, and passes the uniform P to dV alone
in the backward.  Each wrapper checks device, dtype, shape and contiguity,
launches on PyTorch's current stream and counts the call in ``LAUNCHES``:
one forward kernel, or one backward (three kernels: the row sums
``rowsum(dO * O)``, the dK/dV pass and the dQ pass).  They take CUDA
tensors only: ``kernels/ops.py`` sends CPU tensors to
``kernels/ref.py::flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels take, forward and backward (80 on tiles of 128,
# zero columns past 80; 256 in two blocks a head, half of D each)
_HEAD_DIMS = (64, 80, 128, 256)
_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _FWD_ARGTYPES
        lib.flash_attention_bwd.argtypes = _BWD_ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int,
           q_pos: Optional[torch.Tensor] = None,
           k_pos: Optional[torch.Tensor] = None,
           **others: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Raise on anything the kernels do not take; returns (B, Sq, Skv, Hq,
    Hkv, D).  ``others`` are tensors of q's shape and dtype (out, dout);
    ``q_pos``/``k_pos``, both or neither, (B, Sq) and (B, Skv) int32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: expected"
                         " (B, S, H, D)")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v"
                         f" {tuple(v.shape)}: expected k/v (B, Skv, Hkv, D)")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("q_pos and k_pos come together")
    if skv != sq and (causal or window > 0) and q_pos is None:
        raise ValueError(f"q of {sq} rows, k/v of {skv}: another key length"
                         " is taken only with causal=False and window == 0,"
                         " or with positions")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq {hq} is no multiple of Hkv {hkv}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of"
                        " float32 or bfloat16")
    named = {"q": q, "k": k, "v": v, **others}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte"
                             " aligned")
    for name, t in others.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected"
                             f" q's {tuple(q.shape)} {q.dtype}")
    if q_pos is not None:
        for name, t, n in (("q_pos", q_pos, sq), ("k_pos", k_pos, skv)):
            if t.dtype != torch.int32 or tuple(t.shape) != (b, n) \
                    or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on"
                                 f" {t.device}: expected contiguous int32"
                                 f" {(b, n)} on {dev}")
    return b, sq, skv, hq, hkv, d


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address, or None (a null pointer: the index masks)."""
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), float32 or bfloat16,
    contiguous on one CUDA device, D 64, 80, 128 or 256; Skv != Sq only
    with ``causal=False`` and ``window == 0``, or with positions ``q_pos``
    (B, Sq) and ``k_pos`` (B, Skv) int32 (the position masks).  Returns
    the output (B, Sq, Hq, D) in q's dtype and the rows' log-sum-exp (B,
    Hq, Sq) float32."""
    b, sq, skv, hq, hkv, d = _check(q, k, v, causal, window, q_pos=q_pos,
                                    k_pos=k_pos)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    rc = _lib().flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _ptr(q_pos), _ptr(k_pos), b, sq,
        skv, hq, hkv, d, int(causal), int(window), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA"
                           f" error {rc} (q {tuple(q.shape)}, k"
                           f" {tuple(k.shape)})")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention_fwd``'s output
    against ``dout``, from the forward's inputs, output and ``lse`` (and
    its positions); in the inputs' dtype: dq of q's shape, dk/dv of k's.
    D 64, 80, 128 or 256, as the forward."""
    b, sq, skv, hq, hkv, d = _check(q, k, v, causal, window, q_pos=q_pos,
                                    k_pos=k_pos, out=out, dout=dout)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected"
                         f" contiguous float32 {(b, hq, sq)} on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    rowdot = torch.empty_like(lse)
    rc = _lib().flash_attention_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rowdot.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(q_pos),
        _ptr(k_pos), b, sq, skv, hq, hkv, d, int(causal), int(window),
        _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA"
                           f" error {rc} (q {tuple(q.shape)}, k"
                           f" {tuple(k.shape)})")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv

