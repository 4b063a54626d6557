"""The mel frontend of the DSP blocks (window, DFT as two products, power,
mel product, log), fused: the wrapper of the hand-written CUDA kernel in
``csrc/mel_frontend.cu``.

``mel_frontend`` replaces ``repro/kernels/mel_frontend.py:34``.  The
wrapper checks device, dtypes, shapes and strides, launches the kernel on
PyTorch's current stream and counts the launch in ``LAUNCHES``.  It takes
CUDA tensors only: ``kernels/ops.py`` sends CPU tensors to
``kernels/ref.py::mel_frontend_ref``.

The frames come as a ``(B, NF, L)`` (or ``(F, L)``) view with any outer
strides and a unit stride along L, such as ``frame_signal``'s ``unfold``
view of the signal, whose frames overlap: the kernel reads the signal in
place.  Any frame count works: the last tile is masked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"mel_frontend": 0}

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def reset_launches() -> None:
    LAUNCHES["mel_frontend"] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("mel_frontend")
    if lib.mel_frontend.argtypes is None:
        lib.mel_frontend.argtypes = _ARGTYPES
        lib.mel_frontend.restype = ctypes.c_int
    return lib


def _check(frames, window, dft_cos, dft_sin, mel_fb):
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    named = (("frames", frames), ("window", window), ("dft_cos", dft_cos),
             ("dft_sin", dft_sin), ("mel_fb", mel_fb))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, frames on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: expected float32")
    if frames.dim() not in (2, 3) or frames.stride(-1) != 1:
        raise ValueError(f"frames {tuple(frames.shape)} strides"
                         f" {frames.stride()}: expected (F, L) or (B, NF, L)"
                         " with a unit stride along L")
    l = frames.shape[-1]
    nbins = dft_cos.shape[-1]
    if tuple(window.shape) != (l,) or tuple(dft_cos.shape) != (l, nbins) \
            or tuple(dft_sin.shape) != (l, nbins) or mel_fb.dim() != 2 \
            or mel_fb.shape[0] != nbins:
        raise ValueError(
            f"window {tuple(window.shape)}, dft_cos {tuple(dft_cos.shape)},"
            f" dft_sin {tuple(dft_sin.shape)}, mel_fb {tuple(mel_fb.shape)}"
            f": expected (L,), (L, nbins), (L, nbins), (nbins, n_mels) with"
            f" L = {l}")
    for name, t in named[1:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mel_frontend(frames: torch.Tensor, window: torch.Tensor,
                 dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                 mel_fb: torch.Tensor) -> torch.Tensor:
    """frames: (F, L) or (B, NF, L) f32, unit stride along L; window: (L,);
    dft_cos/sin: (L, nbins); mel_fb: (nbins, n_mels), all f32 on one CUDA
    device.  Returns the log-mel energies (F, n_mels) or (B, NF, n_mels)
    f32, within summation order of ``ref.mel_frontend_ref``."""
    _check(frames, window, dft_cos, dft_sin, mel_fb)
    f3 = frames if frames.dim() == 3 else frames.unsqueeze(0)
    nb, nf, l = f3.shape
    n_mels = mel_fb.shape[1]
    out = torch.empty(frames.shape[:-1] + (n_mels,), dtype=torch.float32,
                      device=frames.device)
    if out.numel() == 0:
        return out
    rc = _lib().mel_frontend(
        f3.data_ptr(), f3.stride(0), f3.stride(1), nb, nf, l,
        window.data_ptr(), dft_cos.data_ptr(), dft_sin.data_ptr(),
        mel_fb.data_ptr(), out.data_ptr(), dft_cos.shape[1], n_mels,
        torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mel_frontend kernel launch failed: CUDA error"
                           f" {rc} (frames {tuple(frames.shape)}, nbins"
                           f" {dft_cos.shape[1]}, n_mels {n_mels})")
    LAUNCHES["mel_frontend"] += 1
    return out
