"""The selective scan's launch plan (``kernels/mamba_scan.py::_plan``) and
its kernel's arithmetic, held on the CPU.  No JAX.

The plan: every (batch row, channel) is scanned by exactly one group of
four lanes, a lane holds a quarter of the channel's N states (KPER of
them), and the steps a block stages at S > 1 come in chunks whose bounds
are fixed multiples of the chunk length, covering [0, S) once.  The
sequence is not split across blocks (``csrc/mamba_scan.cu`` says why), so
a padded chunk and its cut prefix scan the same steps in the same order.

The arithmetic: the kernel walks four steps at a time, each lane summing
its states' h * C in state order with fused multiply-adds, then adds the
four lanes' partials as (y0 + y2) + (y1 + y3).  A numpy emulation of that
order stays within ``chip_smoke.py``'s ``MAMBA_TOL`` of the plain version,
and a dt = 0 tail leaves the cut run's final state and outputs bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref

MAMBA_TOL = 2.0 ** -20   # chip_smoke.py's limit, over the largest magnitude
F32 = np.float32


@pytest.mark.parametrize("b,d,n", [(1, 8192, 16), (4, 8192, 16),
                                   (2, 200, 16), (3, 128, 8), (1, 40, 64),
                                   (5, 1, 1)])
def test_plan_scans_every_channel_once(b, d, n):
    """Block (x, y) of the grid holds channels 64 x .. 64 x + 63 of batch
    row y, four lanes a channel; channels past D idle."""
    p = ms._plan(b, 37, d, n, 2)
    assert p.kper == (4 if n <= 16 else 16) and ms.LANES * p.kper >= n
    seen = np.zeros((b, d), int)
    lanes = np.zeros((b, d), int)
    for y in range(p.grid[1]):
        for x in range(p.grid[0]):
            for tid in range(ms.THREADS):
                ch = x * ms.CHANNELS + tid // ms.LANES
                if ch < d:
                    lanes[y, ch] += 1
                    seen[y, ch] += tid % ms.LANES == 0
    assert (seen == 1).all() and (lanes == ms.LANES).all()


@pytest.mark.parametrize("s", [1, 37, 64, 2048])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_chunk_bounds_are_fixed_multiples_and_cover_s_once(s, itemsize):
    p = ms._plan(1, s, 8192, 16, itemsize)
    assert p.chunk == 64 // itemsize and p.chunk % 4 == 0
    ranges = ms.chunk_ranges(p, s)
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(lo % p.chunk == 0 and lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # a padded run's chunks start where its cut prefix's do
    real = min(s, 37)
    assert ms.chunk_ranges(p, real) == [
        (lo, min(hi, real)) for lo, hi in ranges if lo < real]


def _fma(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _emulate(x, dt, bm, cm, a, h0):
    """The kernel's order: U = 4 steps at a time (a ragged last block runs
    on zero rows, dt = 0), four lanes of KPER = 4 states."""
    bsz, s, d = x.shape
    n = bm.shape[-1]
    h = h0.copy()
    y = np.zeros((bsz, s, d), F32)
    pad = -s % 4
    rows = [np.concatenate([t, np.zeros(t.shape[:1] + (pad,) + t.shape[2:],
                                        F32)], axis=1)
            for t in (x, dt, bm, cm)]
    xs, dts, bs, cs = rows
    for t0 in range(0, s + pad, 4):
        dec, inp = [], []
        for u in range(4):
            dtv = dts[:, t0 + u, :, None]
            dx = (dtv[..., 0] * xs[:, t0 + u]).astype(F32)[..., None]
            dec.append(np.exp((dtv * a).astype(F32)).astype(F32))
            inp.append((dx * bs[:, t0 + u, None, :]).astype(F32))
        parts = []
        for u in range(4):
            h = _fma(dec[u], h, inp[u])
            lanes = np.zeros((bsz, d, 4), F32)
            for j in range(n):
                lanes[..., j // 4] = _fma(h[..., j], cs[:, t0 + u, None, j],
                                          lanes[..., j // 4])
            parts.append(lanes)
        for u in range(4):
            if t0 + u < s:
                p = parts[u]
                y[:, t0 + u] = ((p[..., 0] + p[..., 2]).astype(F32)
                                + (p[..., 1] + p[..., 3]).astype(F32))
    return y, h


def _inputs(b, s, d, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, d) * 0.5).astype(F32)
    dt = np.log1p(np.exp(rng.randn(b, s, d) * 0.5)).astype(F32)
    bm = (rng.randn(b, s, n) * 0.5).astype(F32)
    cm = (rng.randn(b, s, n) * 0.5).astype(F32)
    a = (-np.exp(rng.randn(d, n) * 0.3)).astype(F32)
    h0 = rng.randn(b, d, n).astype(F32)
    return x, dt, bm, cm, a, h0


@pytest.mark.parametrize("s", [1, 6, 37, 64])
def test_kernel_order_matches_the_plain_scan(s):
    args = _inputs(2, s, 24, 16, seed=s)
    y, h = _emulate(*args)
    want_y, want_h = (t.numpy() for t in ref.mamba_scan_ref(
        *(torch.from_numpy(t) for t in args)))
    for got, want in ((y, want_y), (h, want_h)):
        reading = np.abs(got - want).max() / np.abs(want).max()
        assert reading <= MAMBA_TOL, reading


def test_dt_zero_tail_gives_the_cut_runs_state_bitwise():
    """A ragged chunk (37 real steps of 64, dt = 0 past them): the final
    state and the real steps' outputs equal the cut run's bit for bit."""
    x, dt, bm, cm, a, h0 = _inputs(2, 64, 24, 16, seed=7)
    real = 37
    masked = dt.copy()
    masked[:, real:] = 0
    y, h = _emulate(x, masked, bm, cm, a, h0)
    y_cut, h_cut = _emulate(*(t[:, :real] for t in (x, dt, bm, cm)), a, h0)
    assert np.array_equal(h, h_cut) and np.array_equal(y[:, :real], y_cut)
    # exp(0 * a) is exactly 1: a whole chunk of dt = 0 leaves h0 as it was
    _, h_same = _emulate(x, np.zeros_like(dt), bm, cm, a, h0)
    assert np.array_equal(h_same, h0)
