"""The selective-scan CUDA kernel against its plain PyTorch version, on the
card, at the shapes the mamba1 serving path gives it.  Skipped without a
GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_mamba_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Tolerance: the largest |kernel - plain| over y and
over h_final, each in units of that output's largest magnitude, within
``MAMBA_TOL``; both sides compute in f32, exp and the sums over the state
rounding in another order.  A masked (dt = 0) pad tail is held bitwise.
``chip_smoke.py`` repeats the check at the full serving shapes and times
the kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# ``chip_smoke.py``'s limit: twice the largest reading on the H100 (4.74e-7,
# a layer of falcon-mamba at full width; this file's seven read 1.94e-7 at
# most), rounded up to a power of two, the rule of the repo's limits
MAMBA_TOL = 2.0 ** -20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, s, d, n, dtype, h0=True, seed=0):
    """The JAX kernel test's distributions: x, B, C ~ N(0, 0.5), dt =
    softplus(N(0, 0.5)), a = -exp(N(0, 0.3)); h0 ~ N(0, 1)."""
    rng = np.random.RandomState(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)
    x = t(rng.randn(b, s, d) * 0.5)
    dt = t(np.log1p(np.exp(rng.randn(b, s, d) * 0.5)))
    bm = t(rng.randn(b, s, n) * 0.5)
    cm = t(rng.randn(b, s, n) * 0.5)
    a = t(-np.exp(rng.randn(d, n) * 0.3), torch.float32)
    hz = t(rng.randn(b, d, n), torch.float32) if h0 else None
    return x, dt, bm, cm, a, hz


def _reading(out, want) -> float:
    return float((out - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype,h0", [
    (1, 64, 8192, 16, torch.bfloat16, True),      # a prefill chunk
    (4, 1, 8192, 16, torch.bfloat16, True),       # a decode step
    (1, 2048, 8192, 16, torch.bfloat16, False),   # a long one-shot scan
    (2, 37, 200, 16, torch.bfloat16, True),       # ragged S and D
    (2, 100, 1000, 16, torch.float32, True),      # f32 inputs
    (3, 9, 128, 8, torch.float32, True),          # the smoke config's N
    (1, 5, 40, 64, torch.float32, True),          # the kernel's largest N
])
def test_kernel_matches_plain_on_card(cuda_device, b, s, d, n, dtype, h0):
    args = _inputs(cuda_device, b, s, d, n, dtype, h0)
    before = tms.LAUNCHES["mamba_scan"]
    y, h = tops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert tms.LAUNCHES["mamba_scan"] == before + 1
    y_want, h_want = tref.mamba_scan_ref(*args)
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    assert y.dtype == h.dtype == torch.float32
    assert bool(y.isfinite().all()) and bool(h.isfinite().all())
    readings = (_reading(y, y_want), _reading(h, h_want))
    print(f"mamba_scan B{b} S{s} D{d} N{n} {dtype}: y {readings[0]:.3g},"
          f" h_final {readings[1]:.3g}")
    assert max(readings) <= MAMBA_TOL, readings


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype", [
    (1, 4096, 64, 16, torch.bfloat16),   # long S: 128 staged chunks
    (3, 1, 37, 16, torch.bfloat16),      # S = 1, rows not 16-byte multiples
    (2, 5, 37, 16, torch.bfloat16),      # a ragged last group of 4 steps,
                                         # plain (not cp.async) staging
    (2, 33, 96, 40, torch.bfloat16),     # 16 states a lane, N < 64
    (1, 70, 64, 64, torch.bfloat16),     # 16 states a lane, vectorized
    (2, 1, 96, 64, torch.float32),       # S = 1 with 16 states a lane
])
def test_each_plan_branch_matches_plain(cuda_device, b, s, d, n, dtype):
    """The plan's states a lane (4 or 16), the decode path (S = 1), the
    staged chunks with 16-byte copies or plain loads, and a ragged tail."""
    args = _inputs(cuda_device, b, s, d, n, dtype, seed=s)
    assert tms._plan(b, s, d, n, args[0].element_size()).kper == (
        4 if n <= 16 else 16)
    y, h = tops.mamba_scan(*args)
    torch.cuda.synchronize()
    y_want, h_want = tref.mamba_scan_ref(*args)
    readings = (_reading(y, y_want), _reading(h, h_want))
    assert max(readings) <= MAMBA_TOL, readings


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_tail_is_bitwise_identity(cuda_device, dtype):
    """dt = 0 on a ragged chunk's tail: the final state equals, bit for
    bit, the kernel's final state on the real prefix alone, and so do the
    real steps' outputs."""
    x, dt, bm, cm, a, h0 = _inputs(cuda_device, 2, 64, 300, 16, dtype)
    real = 37
    dt_masked = dt.clone()
    dt_masked[:, real:] = 0
    y, h = tops.mamba_scan(x, dt_masked, bm, cm, a, h0)
    y_cut, h_cut = tops.mamba_scan(*(t[:, :real].contiguous()
                                     for t in (x, dt, bm, cm)), a, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, h_cut)
    assert torch.equal(y[:, :real], y_cut)
    # a whole chunk of dt = 0 leaves h0 itself
    _, h_same = tops.mamba_scan(x, torch.zeros_like(dt), bm, cm, a, h0)
    assert torch.equal(h_same, h0)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, dt, bm, cm, a, h0 = _inputs(cuda_device, 1, 4, 32, 16, torch.float32)
    with pytest.raises(TypeError):
        tms.mamba_scan(x.bfloat16(), dt, bm, cm, a, h0)
    with pytest.raises(TypeError):
        tms.mamba_scan(x, dt, bm, cm, a.bfloat16(), h0)
    with pytest.raises(ValueError):
        tms.mamba_scan(x, dt, bm[:, :, :8], cm, a, h0)
    with pytest.raises(ValueError):
        tms.mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                       bm, cm, a, h0)
    big = _inputs(cuda_device, 1, 4, 32, 65, torch.float32)
    with pytest.raises(ValueError):
        tms.mamba_scan(*big)
    with pytest.raises(ValueError):
        tms.mamba_scan(*(t.cpu() for t in (x, dt, bm, cm, a, h0)))
