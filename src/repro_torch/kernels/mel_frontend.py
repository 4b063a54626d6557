"""The mel frontend of the DSP blocks (window, DFT as two products, power,
mel product, log), fused: the wrapper of the hand-written CUDA kernel in
``csrc/mel_frontend.cu``.

``mel_frontend`` replaces ``repro/kernels/mel_frontend.py:34``.  The
wrapper checks device, dtypes, shapes and strides, plans the launch from
the shape (``_plan``), launches the kernel on PyTorch's current stream
and counts the launch in ``LAUNCHES``.  It takes CUDA tensors only:
``kernels/ops.py`` sends CPU tensors to ``kernels/ref.py::mel_frontend_ref``.

The frames come as a ``(B, NF, L)`` (or ``(F, L)``) view with any outer
strides and a unit stride along L, such as ``frame_signal``'s ``unfold``
view of the signal, whose frames overlap: the kernel reads the signal in
place.  Any frame count works: the last tile is masked.  Any bin count
works: a bin group with more tiles than its block shape takes runs them
in passes (``pass_tiles``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build

# launches since the last reset (the caller resets)
LAUNCHES = {"mel_frontend": 0}

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

SMS = 132                 # the H100's SMs
MAX_GROUPS = 8            # the portable cluster size
MAX_SMEM = 232_448        # bytes of shared memory a block may take
BK = 16                   # samples of a frame a stage (csrc: Cfg::BK)
THREADS = 256


@dataclasses.dataclass(frozen=True)
class Config:
    """A block shape of the kernel (``csrc/mel_frontend.cu``'s ``Cfg``):
    ``warps_m`` of the 8 warps along the frames, 16 frames each, the rest
    along the bins, ``nt`` bin tiles of 8 a warp at most, a ring of
    ``depth`` stages."""
    warps_m: int
    nt: int
    depth: int

    @property
    def tm(self) -> int:          # frames a block
        return 16 * self.warps_m

    @property
    def warps_n(self) -> int:
        return THREADS // 32 // self.warps_m

    @property
    def max_tiles(self) -> int:   # bin tiles of 8 a block
        return self.warps_n * self.nt

    def smem(self, l: int, n_mels: int, multi: bool = False) -> int:
        """Bytes of dynamic shared memory: the row offsets, the window
        (whole stages), and the larger of the ring (each stage's frame
        chunks and table values, in hi and lo parts) and the epilogue's
        tiles (the mel rows, the power tile, the partial mel tile), which
        alias it; with several passes (``multi``) the partial mel tile
        lies past the ring, whose copies would overwrite it."""
        half = 8 * self.max_tiles
        ring = self.depth * (2 * self.tm * BK + 2 * BK * (2 * half + 4))
        epilogue = half * n_mels + half * (self.tm + 4)
        part = max(ring, epilogue) if multi else epilogue
        body = max(ring, part + self.tm * n_mels)
        return 8 * self.tm + 4 * (_cdiv(l, BK) * BK + body)


# index = the C entry's ``config``: 128, 64 and 16 frames a block
CONFIGS = (Config(warps_m=8, nt=8, depth=3), Config(warps_m=4, nt=8, depth=2),
           Config(warps_m=1, nt=1, depth=4))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: block shape ``config`` (an index into ``CONFIGS``), the
    bins split into ``groups`` groups of whole tiles of 8 (one cluster a
    frame tile), the fullest group in ``passes`` passes, ``blocks``
    blocks and ``smem`` bytes of shared memory each."""
    config: int
    tm: int
    groups: int
    frame_tiles: int
    blocks: int
    smem: int
    passes: int = 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def group_tiles(nbins: int, groups: int) -> List[Tuple[int, int]]:
    """Bin tiles [lo, hi) of each group, as the kernel splits them: group q
    takes [q * T // G, (q + 1) * T // G) of the T = ceil(nbins / 8)."""
    t = _cdiv(nbins, 8)
    return [(q * t // groups, (q + 1) * t // groups) for q in range(groups)]


def pass_tiles(tiles: int, max_tiles: int) -> List[Tuple[int, int]]:
    """A group's bin tiles [lo, hi) of each pass, as the kernel splits its
    ``tiles``: ceil(tiles / max_tiles) passes, as even as whole tiles
    allow (none holds more than ``max_tiles``)."""
    n = max(1, _cdiv(tiles, max_tiles))
    return [(j * tiles // n, (j + 1) * tiles // n) for j in range(n)]


def warp_tiles(tiles: int, warps_n: int) -> List[Tuple[int, int]]:
    """A block's bin tiles [lo, hi) of each warp column, as the kernel
    splits a pass's ``tiles``."""
    return [(w * tiles // warps_n, (w + 1) * tiles // warps_n)
            for w in range(warps_n)]


def _make(i: int, f: int, l: int, ntiles: int, n_mels: int,
          groups: int) -> Plan:
    c = CONFIGS[i]
    mtiles = _cdiv(f, c.tm)
    passes = _cdiv(_cdiv(ntiles, groups), c.max_tiles)
    return Plan(i, c.tm, groups, mtiles, mtiles * groups,
                c.smem(l, n_mels, passes > 1), passes)


@functools.lru_cache(maxsize=None)
def _plan(f: int, l: int, nbins: int, n_mels: int) -> Plan:
    """The launch for ``f`` frames of ``l`` samples, from the shape alone.
    Bins that 8 groups of a block shape cover in one pass (up to 1,024):
    the largest block shape (128 frames, then 64) whose fewest groups give
    at least one block an SM; else the smallest block shape whose bins fit
    8 groups, with as many groups as give one block an SM, at most 8 and
    at most one a bin tile.  More bins: the groups loop over passes, so
    the fewest groups do the least work (each pass streams the frames
    once); the largest block shape whose frame tiles alone give one block
    an SM, in one group; else the smallest, with as many groups as give
    one block an SM (at most 8 and one a tile).  Only block shapes whose
    shared memory fits are taken; a shape that fits none (thousands of
    mels) gets a plan the kernel refuses."""
    ntiles = _cdiv(nbins, 8)
    one_pass = [i for i, c in enumerate(CONFIGS)
                if _cdiv(ntiles, c.max_tiles) <= MAX_GROUPS
                and c.smem(l, n_mels) <= MAX_SMEM]
    shapes = one_pass or [i for i, c in enumerate(CONFIGS)
                          if c.smem(l, n_mels, True) <= MAX_SMEM] \
        or [len(CONFIGS) - 1]

    def fewest(c: Config) -> int:
        return _cdiv(ntiles, c.max_tiles) if one_pass else 1
    for i in shapes:
        c = CONFIGS[i]
        if _cdiv(f, c.tm) * fewest(c) >= SMS:
            return _make(i, f, l, ntiles, n_mels, fewest(c))
    c = CONFIGS[shapes[-1]]
    groups = max(fewest(c),
                 min(MAX_GROUPS, ntiles, _cdiv(SMS, _cdiv(f, c.tm))))
    return _make(shapes[-1], f, l, ntiles, n_mels, groups)


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
    f32: the DFT products on the tensor cores, each operand split into two
    TF32 parts, within ``chip_smoke.py``'s ``MEL_ATOL`` of
    ``ref.mel_frontend_ref``."""
    _check(frames, window, dft_cos, dft_sin, mel_fb)
    f3 = frames if frames.dim() == 3 else frames.unsqueeze(0)
    nb, nf, l = f3.shape
    n_mels = mel_fb.shape[1]
    out = torch.empty(frames.shape[:-1] + (n_mels,), dtype=torch.float32,
                      device=frames.device)
    if out.numel() == 0:
        return out
    nbins = dft_cos.shape[1]
    p = _plan(nb * nf, l, nbins, n_mels)
    rc = _lib().mel_frontend(
        f3.data_ptr(), f3.stride(0), f3.stride(1), nb, nf, l,
        window.data_ptr(), dft_cos.data_ptr(), dft_sin.data_ptr(),
        mel_fb.data_ptr(), out.data_ptr(), nbins, n_mels, p.config,
        p.groups, torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mel_frontend kernel launch failed: CUDA error"
                           f" {rc} (frames {tuple(frames.shape)}, nbins"
                           f" {nbins}, n_mels {n_mels}, {p})")
    LAUNCHES["mel_frontend"] += 1
    return out
