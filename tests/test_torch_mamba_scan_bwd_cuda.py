"""The selective scan's backward kernel against its plain PyTorch version
(``mamba_scan_bwd_ref``), on the card: bf16 and f32, with and without a
carried-in state and a final state's gradient, ragged channel counts, N
up to 64 (16 lanes a channel), S around the segment length (1, L - 1,
L + 1, 3 L + 5) and B 3, ``dt == 0`` pad steps, also across a segment
boundary.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_mamba_scan_bwd_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the check at
falcon-mamba's training shape and times the kernel.

Tolerance, as ``chip_smoke.py``'s ``MAMBA_BWD_TOL``: each gradient's
largest |kernel - plain| beyond its own rounding (2^-8 of each value for
the bf16 gradients dx, ddt, dB, dC; none for dA, dh0 in f32), over that
gradient's largest magnitude, against the plain gradients in f32 from
the same values.  Both sides compute in f32; the sums over channels,
steps and the batch run in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MAMBA_BWD_TOL = 2.0 ** -18
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")
L = tms.SEGMENT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _inputs(dev, b, s, d, n, dtype, carried, pad=0, seed=0):
    """x, B, C ~ N(0, 0.5), dt = softplus(N(0, 0.5)) (0 on the last
    ``pad`` steps), a = -exp(N(0, 0.3)); h0, dy and dh_final ~ N(0, 1)."""
    rng = np.random.RandomState(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)
    dts = np.log1p(np.exp(rng.randn(b, s, d) * 0.5))
    if pad:
        dts[:, s - pad:] = 0
    args = (t(rng.randn(b, s, d) * 0.5), t(dts), t(rng.randn(b, s, n) * 0.5),
            t(rng.randn(b, s, n) * 0.5),
            t(-np.exp(rng.randn(d, n) * 0.3), torch.float32),
            t(rng.randn(b, d, n), torch.float32) if carried else None)
    dy = t(rng.randn(b, s, d), torch.float32)
    dhf = t(rng.randn(b, d, n), torch.float32) if carried else None
    return args, dy, dhf


def _f32(args):
    return [None if t is None else t.float() for t in args]


def _readings(got, want) -> dict:
    out = {}
    for name, g, w in zip(NAMES, got, want):
        w = w.float()
        rounding = 2.0 ** -8 if g.dtype == torch.bfloat16 else 0.0
        excess = (g.float() - w).abs() - rounding * w.abs()
        out[name] = float(excess.max().clamp(min=0)) / float(w.abs().max())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype,carried", [
    (1, 300, 512, 16, torch.bfloat16, False),    # falcon-mamba-like
    (2, 100, 200, 16, torch.bfloat16, True),     # ragged channels, carried
    (2, 64, 128, 8, torch.float32, True),        # the smoke width, f32
    (1, 50, 96, 64, torch.float32, True),        # 16 states a lane
    (1, 40, 64, 33, torch.float32, True),        # N of no whole lane
    (2, 1, 256, 16, torch.bfloat16, True),       # one step
    (3, L - 1, 192, 16, torch.bfloat16, True),   # one segment, B 3
    (2, L + 1, 96, 64, torch.float32, True),     # a one-step segment, N 64
    (3, 3 * L + 5, 200, 16, torch.bfloat16, True),   # four segments
    (1, 3 * L + 5, 48, 64, torch.bfloat16, False),   # N 64 in bf16
])
def test_backward_against_plain(cuda_device, b, s, d, n, dtype, carried):
    args, dy, dhf = _inputs(cuda_device, b, s, d, n, dtype, carried)
    got = tms.mamba_scan_bwd(*args, dy, dhf)
    # the plain gradients in f32 from the same values (unrounded)
    want = tref.mamba_scan_bwd_ref(*_f32(args), dy, dhf)
    for g, w, t in zip(got, want, args[:4] + (args[4], args[4])):
        assert g.shape == w.shape and g.dtype == t.dtype
        assert bool(g.isfinite().all())
    read = _readings(got, want)
    assert max(read.values()) <= MAMBA_BWD_TOL, read


@pytest.mark.cuda
@pytest.mark.parametrize("real,pad", [
    (70, 26),                  # inside one segment
    (L - 30, 60),              # across a segment boundary
    (2 * L - 5, L + 10),       # one step short of a boundary, two past
])
def test_pad_steps_and_the_same_bits(cuda_device, real, pad):
    """``dt == 0`` pad steps with no output gradient leave the prefix's
    gradients bit for bit as the prefix alone gives them (the pads pass
    the state's gradient on exactly and add exact zeros to dA, and the
    segments start at the same steps), and two runs give the same bits."""
    args, dy, dhf = _inputs(cuda_device, 2, real + pad, 256, 16,
                            torch.bfloat16, True, pad=pad, seed=1)
    dy[:, real:] = 0
    full = tms.mamba_scan_bwd(*args, dy, dhf)
    again = tms.mamba_scan_bwd(*args, dy, dhf)
    assert all(torch.equal(u, v) for u, v in zip(full, again))
    cut = tms.mamba_scan_bwd(*(t[:, :real].contiguous() for t in args[:4]),
                             args[4], args[5], dy[:, :real].contiguous(), dhf)
    trimmed = [g[:, :real] for g in full[:4]] + list(full[4:])
    assert all(torch.equal(u, v) for u, v in zip(trimmed, cut))


@pytest.mark.cuda
def test_autograd_launches_the_kernel(cuda_device):
    """``ops.mamba_scan`` under autograd on the card: one forward and one
    backward launch, the backward kernel's gradients, h_final's unused
    gradient taken as zeros."""
    args, dy, _ = _inputs(cuda_device, 1, 64, 256, 16, torch.bfloat16,
                          True, seed=2)
    leaves = [t.clone().requires_grad_() for t in args]
    tms.reset_launches()
    y, _ = tops.mamba_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    assert tms.LAUNCHES == {"mamba_scan": 1, "mamba_scan_bwd": 1}
    want = tms.mamba_scan_bwd(*args, dy, None)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
