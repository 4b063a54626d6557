"""The selective scan of the mamba1 layer: the wrapper of the hand-written
CUDA kernel in ``csrc/mamba_scan.cu``.

``mamba_scan`` replaces ``repro/kernels/mamba_scan.py:49``, and takes a
carried-in state ``h0``, which the TPU kernel did not.  ``mamba_scan_bwd``
is the scan's gradient, which the TPU kernel never had (XLA
differentiates the reference's associative scan): four kernels a call
over segments of ``SEGMENT`` steps (``_bwd_plan``), counted as one
launch.  The wrapper checks device, dtypes, shapes and contiguity, plans
the launch from the shape (``_plan``), allocates y and the final state,
launches the kernel on PyTorch's current stream and counts the launch in
``LAUNCHES``.  It takes CUDA tensors only: ``kernels/ops.py`` sends CPU
tensors to ``kernels/ref.py::mamba_scan_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"mamba_scan": 0, "mamba_scan_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 64            # the kernel's largest N (4 lanes x 16 states)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 17
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# the kernel's constants (csrc/mamba_scan.cu): lanes a channel, threads a
# block, and the steps a staged chunk holds (64 bytes of each column)
LANES = 4
THREADS = 256
CHANNELS = THREADS // LANES


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``kper`` states a lane (a quarter of a channel's N), a
    grid of (channel blocks, batch rows) of ``CHANNELS`` channels each,
    and ``chunk`` steps staged at a time when S > 1 (none at S = 1)."""
    kper: int
    grid: Tuple[int, int]
    chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _plan(b: int, s: int, d: int, n: int, itemsize: int) -> Plan:
    """The launch for a (B, S, D) scan of N states with inputs of
    ``itemsize`` bytes, from the shape alone.  Block x of batch row y
    takes channels [64 x, 64 x + 64) of row y (those below D)."""
    return Plan(4 if n <= 16 else 16, (_cdiv(d, CHANNELS), b),
                64 // itemsize)


def chunk_ranges(p: Plan, s: int) -> List[Tuple[int, int]]:
    """The steps [lo, hi) of each chunk the kernel stages at S > 1: fixed
    multiples of the chunk length, the last one cut at S."""
    return [(t0, min(s, t0 + p.chunk)) for t0 in range(0, s, p.chunk)]


# the backward's constants (csrc/mamba_scan.cu): steps a segment (kSeg),
# which start at fixed multiples of it from t = 0, and states a lane (kSt)
SEGMENT = 128
BWD_STATES = 4


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's launch: ``lanes`` lanes a channel of ``BWD_STATES``
    states each, ``channels`` channels a block, and a grid of (channel
    blocks, segments, batch rows), the same for its summary and main
    kernels."""
    lanes: int
    channels: int
    grid: Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def _bwd_plan(b: int, s: int, d: int, n: int) -> BwdPlan:
    """The backward's launch for a (B, S, D) scan of N states: 4 lanes a
    channel up to N 16, 16 up to N 64 (the forward's ``kper``, which the
    kernel is given, picks them)."""
    lanes = 4 if n <= 16 else 16
    ch = THREADS // lanes
    return BwdPlan(lanes, ch, (_cdiv(d, ch), _cdiv(s, SEGMENT), b))


def segment_ranges(s: int) -> List[Tuple[int, int]]:
    """The steps [lo, hi) of each segment of the backward: fixed multiples
    of ``SEGMENT``, the last one cut at S."""
    return [(t0, min(s, t0 + SEGMENT)) for t0 in range(0, s, SEGMENT)]


def bwd_scratch(p: BwdPlan, s: int, d: int, n: int) -> dict:
    """The f32 scratch shapes of a backward call: ``seg`` (3, B, segments,
    D, N), each segment's local end state, gradient from a zero carry and
    product of decays (then the state and the gradient entering it, and
    its dA partial); ``pdb`` and ``pdc`` (B, channel blocks, S, N), the
    per-block partials of dB and dC."""
    nblk, nseg, bsz = p.grid
    return {"seg": (3, bsz, nseg, d, n), "pdb": (bsz, nblk, s, n),
            "pdc": (bsz, nblk, s, n)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    if lib.mamba_scan.argtypes is None:
        lib.mamba_scan.argtypes = _ARGTYPES
        lib.mamba_scan.restype = ctypes.c_int
        lib.mamba_scan_bwd.argtypes = _BWD_ARGTYPES
        lib.mamba_scan_bwd.restype = ctypes.c_int
    return lib


def _check(x, dt, b_mat, c_mat, a, h0) -> Tuple[int, int, int, int]:
    """Raise on anything the kernel does not take; returns (B, S, D, N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if x.dim() != 3 or b_mat.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, b_mat {tuple(b_mat.shape)}:"
                         " expected (B, S, D) and (B, S, N)")
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    shapes = {"dt": (dt, (bsz, s, d)), "b_mat": (b_mat, (bsz, s, n)),
              "c_mat": (c_mat, (bsz, s, n)), "a": (a, (d, n))}
    if h0 is not None:
        shapes["h0"] = (h0, (bsz, d, n))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)}: expected {want}")
    if min(bsz, s, d, n) < 1 or n > MAX_STATE or bsz > 65535:
        raise ValueError(f"(B, S, D, N) = {(bsz, s, d, n)}: the kernel takes"
                         f" sizes >= 1, N <= {MAX_STATE}, B <= 65535")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, b_mat, c_mat)):
        raise TypeError(f"x/dt/b_mat/c_mat dtypes {x.dtype}/{dt.dtype}/"
                        f"{b_mat.dtype}/{c_mat.dtype}: one of float32 or"
                        " bfloat16")
    named = {"x": x, "dt": dt, "b_mat": b_mat, "c_mat": c_mat, "a": a}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("a", "h0"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} is {named[name].dtype}: expected"
                            " float32")
    return bsz, s, d, n


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (B, S, D), b_mat/c_mat: (B, S, N), one dtype (bf16 or f32);
    a: (D, N) f32; h0: (B, D, N) f32 or None (zeros); all contiguous on one
    CUDA device.  Returns (y (B, S, D) f32, h_final (B, D, N) f32), within
    rounding of ``ref.mamba_scan_ref``."""
    bsz, s, d, n = _check(x, dt, b_mat, c_mat, a, h0)
    p = _plan(bsz, s, d, n, x.element_size())
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
    h_final = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    rc = _lib().mamba_scan(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), bsz, s, d, n, p.kper,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {rc}"
                           f" (B, S, D, N = {bsz}, {s}, {d}, {n})")
    LAUNCHES["mamba_scan"] += 1
    return y, h_final


def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor], dy: torch.Tensor,
                   dh_final: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``mamba_scan`` against ``dy`` (B, S, D) f32 and
    ``dh_final`` (B, D, N) f32 or None (zeros), from the forward's inputs
    (as ``mamba_scan`` takes them).  Returns (dx, ddt, dB, dC) in x's
    dtype and (dA (D, N), dh0 (B, D, N)) in f32, within rounding of
    ``ref.mamba_scan_bwd_ref``; the same bits on every run.

    The sequence is cut into segments of ``SEGMENT`` steps
    (``segment_ranges``) and scanned in two levels: each segment's
    summaries from zeros, a combine over the segments for the state and
    the gradient entering each, then each segment's gradients from them
    (``csrc/mamba_scan.cu`` gives the design).  The scratch follows
    ``bwd_scratch``."""
    bsz, s, d, n = _check(x, dt, b_mat, c_mat, a, h0)
    dev = x.device
    for name, t, want in (("dy", dy, (bsz, s, d)),
                          ("dh_final", dh_final, (bsz, d, n))):
        if t is None:
            continue
        if tuple(t.shape) != want or t.dtype != torch.float32 \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on"
                             f" {t.device}: expected contiguous float32"
                             f" {want} on {dev}")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    scratch = {name: f32(*shape) for name, shape in
               bwd_scratch(_bwd_plan(bsz, s, d, n), s, d, n).items()}
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    da, dh0 = f32(d, n), f32(bsz, d, n)
    rc = _lib().mamba_scan_bwd(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        dy.data_ptr(), None if dh_final is None else dh_final.data_ptr(),
        scratch["seg"].data_ptr(), scratch["pdb"].data_ptr(),
        scratch["pdc"].data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        db.data_ptr(), dc.data_ptr(), da.data_ptr(), dh0.data_ptr(), bsz, s,
        d, n, _plan(bsz, s, d, n, x.element_size()).kper,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA error"
                           f" {rc} (B, S, D, N = {bsz}, {s}, {d}, {n})")
    LAUNCHES["mamba_scan_bwd"] += 1
    return dx, ddt, db, dc, da, dh0
