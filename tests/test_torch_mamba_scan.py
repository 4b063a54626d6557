"""Port parity: the plain selective scan (``kernels/ref.py::mamba_scan_ref``,
what ``ops.mamba_scan`` runs on the CPU and what the CUDA kernel is held
to on the card) against the JAX package's scan.

On the CPU.  Inputs are drawn with numpy and handed to both packages: the
JAX Pallas kernel in interpret mode at ``tests/test_kernels.py``'s shapes
(from zeros, the only start it takes) and the JAX ``mamba_scan_ref`` with
a carried-in state, each within 2e-5, the JAX kernel test's own limit.
Steps with ``dt == 0`` leave the state exactly as it was.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(b, s, d, n, seed=0):
    """The JAX kernel test's distributions, as numpy f32: x, B, C ~ N(0,
    0.5), dt = softplus(N(0, 0.5)), a = -exp(N(0, 0.3)); h0 ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, d) * 0.5
    dt = np.log1p(np.exp(rng.randn(b, s, d) * 0.5))
    bm = rng.randn(b, s, n) * 0.5
    cm = rng.randn(b, s, n) * 0.5
    a = -np.exp(rng.randn(d, n) * 0.3)
    h0 = rng.randn(b, d, n)
    return [v.astype(np.float32) for v in (x, dt, bm, cm, a, h0)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,d,n", [(128, 64, 16), (256, 64, 16),
                                   (128, 128, 8)])
def test_plain_scan_matches_pallas_interpret(s, d, n):
    x, dt, bm, cm, a, _ = _inputs(2, s, d, n)
    yj, hj = jops.mamba_scan(*(jnp.asarray(v) for v in (x, dt, bm, cm, a)),
                             force="interpret")
    y, h = tops.mamba_scan(*_torch((x, dt, bm, cm, a)))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)


@pytest.mark.parametrize("b,s,d,n", [(2, 37, 24, 16), (3, 1, 128, 8)])
def test_plain_scan_with_state_matches_jax_ref(b, s, d, n):
    x, dt, bm, cm, a, h0 = _inputs(b, s, d, n, seed=1)
    yj, hj = jref.mamba_scan_ref(*(jnp.asarray(v)
                                   for v in (x, dt, bm, cm, a)),
                                 h0=jnp.asarray(h0))
    y, h = tref.mamba_scan_ref(*_torch((x, dt, bm, cm, a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)


def test_bf16_inputs_are_widened_exactly():
    """bf16 activations give the scan of their exact f32 values."""
    x, dt, bm, cm, a, h0 = _torch(_inputs(2, 9, 32, 8, seed=2))
    low = [t.bfloat16() for t in (x, dt, bm, cm)]
    got = tops.mamba_scan(*low, a, h0)
    want = tref.mamba_scan_ref(*(t.float() for t in low), a, h0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_zero_dt_steps_are_an_exact_identity():
    """A masked pad tail (dt == 0) leaves the final state bit for bit where
    the real prefix put it, and a chunk of dt == 0 leaves h0 itself."""
    x, dt, bm, cm, a, h0 = _torch(_inputs(2, 16, 24, 16, seed=3))
    real = 11
    dt_masked = dt.clone()
    dt_masked[:, real:] = 0
    y, h = tops.mamba_scan(x, dt_masked, bm, cm, a, h0)
    y_cut, h_cut = tops.mamba_scan(x[:, :real], dt[:, :real], bm[:, :real],
                                   cm[:, :real], a, h0)
    assert torch.equal(h, h_cut) and torch.equal(y[:, :real], y_cut)
    _, h_same = tops.mamba_scan(x, torch.zeros_like(dt), bm, cm, a, h0)
    assert torch.equal(h_same, h0)
