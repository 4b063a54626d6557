"""The selective scan's backward on the CPU: ``mamba_scan_bwd_ref`` (the
plain reverse sweep the CUDA kernel is held to) against autograd through
``mamba_scan_ref`` and against ``jax.vjp`` of the JAX package's
``mamba_scan_ref``; ``torch.autograd.gradcheck`` of the registered
operator in float64; the operator's autograd equal to autograd through the
plain loop.

Tolerances: autograd through the same f32 loop sums in the same order
as the explicit sweep up to the reassociation of one product, so the two
agree to a few f32 ulp of each gradient's largest magnitude (``RTOL_MAX``
2^-20 of it); against JAX, which sums the same terms in XLA's order, the
same.  ``dt == 0`` pad steps pass the state's gradient on unchanged, so a
masked tail gives the real prefix's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
RTOL_MAX = 2.0 ** -20
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def _inputs(b, s, d, n, dtype=np.float32, h0=True, pad=0, seed=0):
    """The JAX kernel test's distributions: x, B, C ~ N(0, 0.5), dt =
    softplus(N(0, 0.5)) (0 on the last ``pad`` steps), a = -exp(N(0,
    0.3)), h0 ~ N(0, 1); and the output gradients dy, dh_final ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, d) * 0.5).astype(dtype)
    dt = np.log1p(np.exp(rng.randn(b, s, d) * 0.5)).astype(dtype)
    if pad:
        dt[:, s - pad:] = 0
    bm = (rng.randn(b, s, n) * 0.5).astype(dtype)
    cm = (rng.randn(b, s, n) * 0.5).astype(dtype)
    a = (-np.exp(rng.randn(d, n) * 0.3)).astype(np.float32)
    hz = rng.randn(b, d, n).astype(np.float32) if h0 else None
    dy = rng.randn(b, s, d).astype(np.float32)
    dhf = rng.randn(b, d, n).astype(np.float32)
    return (x, dt, bm, cm, a, hz), dy, dhf


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _autograd(args, dy, dhf):
    """Autograd through the plain loop: (dx, ddt, dB, dC, dA, dh0)."""
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in args]
    y, h = tref.mamba_scan_ref(*leaves)
    loss = (y * dy).sum() + (0 if dhf is None else (h * dhf).sum())
    wanted = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(loss, wanted))
    return [None if t is None else next(grads) for t in leaves]


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        err = float((g.float() - w.float()).abs().max())
        assert err <= RTOL_MAX * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("h0,with_dhf", [(True, True), (False, True),
                                         (True, False), (False, False)])
def test_reverse_sweep_matches_autograd(h0, with_dhf):
    """With and without a carried-in state and a final state's gradient:
    every gradient of the explicit sweep equals autograd's through the
    plain loop within ``RTOL_MAX`` of its largest magnitude."""
    arrays, dy, dhf = _inputs(2, 37, 24, 8, h0=h0, seed=1)
    args = _t(arrays)
    dy, dhf = torch.from_numpy(dy), (torch.from_numpy(dhf) if with_dhf
                                     else None)
    got = tref.mamba_scan_bwd_ref(*args, dy, dhf)
    want = _autograd(args, dy, dhf)
    assert got[3].shape == args[3].shape and got[5].shape == (2, 24, 8)
    _close(got, want)


def test_pad_steps_pass_the_gradient_on():
    """``dt == 0`` steps leave the state as it was: with a masked tail and
    no gradient on its outputs, the real prefix's gradients are those of
    the prefix alone (the pad steps' decay is exactly 1)."""
    real, pad = 29, 11
    arrays, dy, dhf = _inputs(2, real + pad, 16, 8, pad=pad, seed=2)
    args = _t(arrays)
    dy = torch.from_numpy(dy)
    dy[:, real:] = 0
    dhf = torch.from_numpy(dhf)
    full = tref.mamba_scan_bwd_ref(*args, dy, dhf)
    cut = tref.mamba_scan_bwd_ref(*(t[:, :real] for t in args[:4]), args[4],
                                  args[5], dy[:, :real], dhf)
    for name, f, c in zip(NAMES, full, cut):
        if name in ("dA", "dh0"):
            torch.testing.assert_close(f, c, rtol=0, atol=0)
        else:
            torch.testing.assert_close(f[:, :real], c, rtol=0, atol=0)
    assert float(full[2][:, real:].abs().max()) == 0.0   # dB of pad steps
    _close(full, _autograd(args, dy, dhf))


def test_bf16_inputs_give_bf16_gradients():
    """bf16 activations: dx, ddt, dB and dC come back in bf16 (the f32
    sweep rounded once), dA and dh0 in f32."""
    arrays, dy, dhf = _inputs(1, 16, 32, 16, seed=3)
    args = _t(arrays)
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16)
    got = tref.mamba_scan_bwd_ref(*args, torch.from_numpy(dy),
                                  torch.from_numpy(dhf))
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    f32 = tref.mamba_scan_bwd_ref(*(a.float() if a is not None else a
                                    for a in args),
                                  torch.from_numpy(dy), torch.from_numpy(dhf))
    for g, w in zip(got[:4], f32[:4]):
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("pad", [0, 5])
def test_matches_jax_vjp_of_the_reference_scan(pad):
    """Against ``jax.vjp`` of the JAX package's plain scan (its
    ``lax.scan``), on the same inputs, with h0 and both output
    gradients."""
    arrays, dy, dhf = _inputs(2, 33, 20, 8, pad=pad, seed=4)
    x, dt, bm, cm, a, hz = arrays
    _, vjp = jax.vjp(lambda *t: jref.mamba_scan_ref(*t),
                     *(jnp.asarray(v) for v in arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    got = tref.mamba_scan_bwd_ref(*_t(arrays), torch.from_numpy(dy),
                                  torch.from_numpy(dhf))
    # jax.vjp's order: x, dt, b, c, a, h0; ours: dx, ddt, dB, dC, dA, dh0
    _close(got, [torch.from_numpy(np.array(w)) for w in want])


def test_registered_op_gradcheck_f64():
    """``torch.autograd.gradcheck`` of ``ops.mamba_scan`` (the custom
    operator with its registered backward) in float64, both outputs, every
    input, two pad steps at the end."""
    rng = np.random.RandomState(5)
    b, s, d, n = 2, 6, 3, 2
    dt = np.log1p(np.exp(rng.randn(b, s, d) * 0.5))
    dt[:, -2:] = 0
    args = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (rng.randn(b, s, d) * 0.5, dt, rng.randn(b, s, n) * 0.5,
                      rng.randn(b, s, n) * 0.5, -np.exp(rng.randn(d, n) * 0.3),
                      rng.randn(b, d, n))]
    assert torch.autograd.gradcheck(lambda *t: tops.mamba_scan(*t),
                                    tuple(args))
    assert torch.autograd.gradcheck(lambda *t: tops.mamba_scan(*t)[0],
                                    tuple(args[:5]))


def test_registered_op_autograd_is_the_plain_loops():
    """On the CPU the operator's backward is ``mamba_scan_bwd_ref``:
    autograd through ``ops.mamba_scan`` gives autograd through the plain
    loop's gradients (``RTOL_MAX``), with the final state unused (its
    gradient comes in as zeros or None and is taken as zeros)."""
    arrays, dy, _ = _inputs(2, 21, 16, 8, seed=6)
    args = _t(arrays)
    leaves = [t.clone().requires_grad_() for t in args]
    y, _ = tops.mamba_scan(*leaves)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    want = _autograd(args, torch.from_numpy(dy), None)
    _close(got, want)


def test_forward_stays_one_node_in_export():
    """The serving path's export still sees the one forward node: the
    autograd formula adds no node to an inference program."""
    arrays, _, _ = _inputs(1, 4, 8, 4, seed=7)

    class Scan(torch.nn.Module):
        def forward(self, x, dt, bm, cm, a, h0):
            return tops.mamba_scan(x, dt, bm, cm, a, h0)
    prog = torch.export.export(Scan(), tuple(_t(arrays)))
    targets = [str(nd.target) for nd in prog.graph.nodes
               if nd.op == "call_function"]
    assert targets.count("repro_torch.mamba_scan.default") == 1
    assert not any("mamba_scan_bwd" in t for t in targets)


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: the CPU takes the
    plain sweep through the operator, never the wrapper."""
    arrays, dy, dhf = _inputs(1, 4, 8, 4, seed=8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tms.mamba_scan_bwd(*_t(arrays), torch.from_numpy(dy),
                           torch.from_numpy(dhf))


def test_backward_scratch_plan():
    """The backward's plan: segments of ``SEGMENT`` steps at fixed
    multiples from t = 0 cover [0, S) once, the last one cut at S; the
    grid at falcon-mamba's training shape; the scratch the wrapper
    allocates (``bwd_scratch``), 4 lanes of 4 states a channel up to N 16
    and 16 lanes up to N 64."""
    L = tms.SEGMENT
    assert L == 128 and tms.BWD_STATES == 4
    for s in (1, L - 1, L, L + 1, 2048):
        ranges = tms.segment_ranges(s)
        assert [lo for lo, _ in ranges] == list(range(0, s, L))
        assert all(0 < hi - lo <= L for lo, hi in ranges)
        assert all(h == lo for (_, h), (lo, _) in zip(ranges, ranges[1:]))
        assert ranges[0][0] == 0 and ranges[-1][1] == s
    p = tms._bwd_plan(1, 2048, 8192, 16)
    assert (p.lanes, p.channels, p.grid) == (4, 64, (128, 16, 1))
    assert p.lanes * tms.BWD_STATES >= 16
    assert p.lanes == tms._plan(1, 2048, 8192, 16, 2).kper
    scratch = tms.bwd_scratch(p, 2048, 8192, 16)
    assert scratch == {"seg": (3, 1, 16, 8192, 16),
                       "pdb": (1, 128, 2048, 16), "pdc": (1, 128, 2048, 16)}
    # 25.2 MB of summaries, 33.6 MB of per-block partials
    assert [4 * int(np.prod(v)) for v in scratch.values()] == [
        25_165_824, 16_777_216, 16_777_216]
    wide = tms._bwd_plan(3, L + 1, 100, 64)
    assert (wide.lanes, wide.channels, wide.grid) == (16, 16, (7, 2, 3))
    assert wide.lanes * tms.BWD_STATES == tms.MAX_STATE
    assert tms.bwd_scratch(wide, L + 1, 100, 64)["seg"] == (3, 3, 2, 100, 64)
    assert "mamba_scan_bwd" in tms.LAUNCHES


def test_two_level_decomposition_f64():
    """The backward's two levels written out in float64 over the plan's
    segments: each segment's summaries from zeros (local end state, the
    product of its decays, the gradient sent out of its start from a zero
    carry, as forward sums), the combine over the segments (the state and
    the gradient entering each), then each segment's forward sweep from
    its state and reverse sweep from its gradient.  At a ragged S of three
    segments, with a carried state, a final state's gradient and dt = 0
    pad steps (dy = 0 on them) that straddle a segment boundary, it gives
    ``mamba_scan_bwd_ref``'s gradients (1e-12 of each one's largest)."""
    L = tms.SEGMENT
    b, s, d, n, pad = 2, 2 * L + 37, 6, 5, 40
    arrays, dy, dhf = _inputs(b, s, d, n, dtype=np.float64, pad=pad, seed=9)
    dy[:, s - pad:] = 0
    x, dt, bm, cm, a, h0 = (torch.from_numpy(v.astype(np.float64))
                            for v in arrays)
    dy, dhf = torch.from_numpy(dy).double(), torch.from_numpy(dhf).double()
    assert s - pad < 2 * L < s        # the pads cross a boundary
    dec = torch.exp(dt[..., None] * a)                 # (B, S, D, N)
    inp = (dt * x)[..., None] * bm[:, :, None, :]
    dyc = dy[..., None] * cm[:, :, None, :]
    segs = tms.segment_ranges(s)
    assert len(segs) == 3
    # 1. summaries from zeros
    summ = []
    for lo, hi in segs:
        h, q, gl = (torch.zeros(b, d, n, dtype=torch.float64),
                    torch.ones(b, d, n, dtype=torch.float64),
                    torch.zeros(b, d, n, dtype=torch.float64))
        for t in range(lo, hi):
            h = dec[:, t] * h + inp[:, t]
            q = q * dec[:, t]
            gl = gl + q * dyc[:, t]
        summ.append((h, q, gl))
    # 2. the combine
    hin, gin = [h0], [None] * len(segs)
    for hl, p, _ in summ[:-1]:
        hin.append(p * hin[-1] + hl)
    gin[-1] = dhf
    for k in range(len(segs) - 1, 0, -1):
        gin[k - 1] = summ[k][1] * gin[k] + summ[k][2]
    # 3. each segment's sweeps
    dx, ddt = torch.zeros(b, s, d, dtype=torch.float64), \
        torch.zeros(b, s, d, dtype=torch.float64)
    db, dc = torch.zeros(b, s, n, dtype=torch.float64), \
        torch.zeros(b, s, n, dtype=torch.float64)
    da, dh0 = torch.zeros(d, n, dtype=torch.float64), None
    for k, (lo, hi) in enumerate(segs):
        hs = [hin[k]]
        for t in range(lo, hi):
            hs.append(dec[:, t] * hs[-1] + inp[:, t])
        g = gin[k]
        for t in reversed(range(lo, hi)):
            g = g + dyc[:, t]
            gb = (g * bm[:, t, None, :]).sum(-1)
            gh = g * hs[t - lo] * dec[:, t]
            dx[:, t] = dt[:, t] * gb
            ddt[:, t] = x[:, t] * gb + (gh * a).sum(-1)
            db[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
            dc[:, t] = torch.einsum("bdn,bd->bn", hs[t - lo + 1], dy[:, t])
            da += (gh * dt[:, t, :, None]).sum(0)
            g = dec[:, t] * g
        if k == 0:
            dh0 = g
    want = tref.mamba_scan_bwd_ref(x, dt, bm, cm, a, h0, dy, dhf)
    for name, got, w in zip(NAMES, (dx, ddt, db, dc, da, dh0), want):
        assert got.dtype == w.dtype == torch.float64, name
        err = float((got - w).abs().max())
        assert err <= 1e-12 * float(w.abs().max()), (name, err)
