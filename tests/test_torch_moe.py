"""Port parity: the mixture-of-experts layer (``models/moe.py``) against
``repro.models.moe``, on the CPU.

Routing is held **bitwise**: ``route_topk``'s expert ids, and
``_dispatch_indices``'s rows, slots and keep mask, including planted
ties (equal router columns, all-zero tokens) in float32 and in bfloat16,
where the reference's ``lax.top_k`` puts the lower index first.  The
capacity formula, the overflow of a skewed router (T x k above 128: the
rows past an expert's capacity dropped, the same rows on both sides),
``moe_layer_dense`` at float32 (1e-5) and at bfloat16, and
``aux_load_balance_loss``.  Gradients: the layer's (input, router, three
banks) and ``forward_train``'s on both MoE smoke configs against
``jax.grad``, with and without remat, and the recomputed routing under
remat equal to the forward's.

bfloat16 inputs are made exact: integer activations and router weights
in multiples of 1/8, so every router logit is the same float32 sum in
any order and rounds once to the same bfloat16 on both sides.  The
experts' products then differ only by bfloat16 rounding in another
order: ``BF16_ATOL`` (2^-5 of the output's largest magnitude; readings
stay below 2^-7 of it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.arch import ArchConfig as JArchConfig
from repro.data import synthetic as jsyn
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.core.arch import ArchConfig
from repro_torch.core.tree import leaves
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

ARCHS = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")
ATOL = 1e-5
BF16_ATOL = 2.0 ** -5
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _cfgs(e=4, k=2, d=64, f=96, cf=1.25):
    kw = dict(name="moe-test", family="moe", n_layers=1, d_model=d,
              n_heads=4, n_kv_heads=2, d_ff=f, vocab_size=320,
              n_experts=e, experts_per_tok=k, capacity_factor=cf)
    return JArchConfig(**kw), ArchConfig(**kw)


def _tied_logits(rng, t, e):
    """(T, E) logits in multiples of 1/4 from a narrow range: ties at
    every rank are common; some rows all equal."""
    logits = rng.randint(-3, 4, (t, e)).astype(np.float32) / 4
    logits[::7] = 0.5
    logits[1::5, 1] = logits[1::5, 2]
    return logits


def _exact_inputs(rng, t, e, d, f, skew=0.0):
    """x (T, d) of small integers and a router (d, E) in multiples of 1/8
    whose columns 1 and E - 1 are equal (tied logits); ``skew`` adds to
    column 0 through a constant feature, so expert 0 overflows.  Banks
    normal, scaled."""
    x = rng.randint(-2, 3, (t, d)).astype(np.float32)
    x[:, 0] = 1.0
    x[3::11] = 0.0                                   # every logit 0
    router = rng.randint(-2, 3, (d, e)).astype(np.float32) / 8
    router[:, -1] = router[:, 1]
    router[0, 0] += skew
    p = {"router": router,
         "w_gate": rng.randn(e, d, f).astype(np.float32) * 0.1,
         "w_up": rng.randn(e, d, f).astype(np.float32) * 0.1,
         "w_down": rng.randn(e, f, d).astype(np.float32) * 0.1}
    return x, p


def _both(x, p, dtype):
    """The inputs in ``dtype`` for both packages (the banks too, as the
    serving weights are stored)."""
    npdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x.astype(npdt))
    jp = {k: jnp.asarray(v.astype(npdt)) for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    return jx, jp, tx, tp


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_topk_matches_jax_with_ties(dtype, k):
    """Planted ties at every rank: the expert ids are the reference's
    bit for bit (the lower index first among equal logits), the weights
    within 1e-6 (both softmax in float32)."""
    npdt, tdt = DTYPES[dtype]
    logits = _tied_logits(np.random.RandomState(k), 97, 6)
    jidx, jw = jmoe.route_topk(jnp.asarray(logits.astype(npdt)), k)
    tidx, tw = tmoe.route_topk(torch.from_numpy(logits).to(tdt), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert tw.dtype == torch.float32
    # a row of equal logits routes to experts 0..k-1, in order
    np.testing.assert_array_equal(tidx[0].numpy(), np.arange(k))


@pytest.mark.parametrize("capacity", [2, 9, 128])
def test_dispatch_indices_bitwise(capacity):
    """Rows, slots (the scratch slot ``capacity`` for a dropped row) and
    the keep mask equal the reference's; small capacities drop rows."""
    logits = _tied_logits(np.random.RandomState(capacity), 64, 4)
    jf, js, jk, jw = jmoe._dispatch_indices(jnp.asarray(logits), 2, 4,
                                            capacity)
    tf, ts, tk, tw = tmoe._dispatch_indices(torch.from_numpy(logits), 2, 4,
                                            capacity)
    for got, want in ((tf, jf), (ts, js), (tk, jk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    if capacity < 128:
        assert not tk.all() and int(ts.max()) == capacity


def test_capacity_formula_matches_jax():
    """``max(round_up(int(cf T k / E), 128), 128)``: the reference's
    capacity for the smoke and full configs over T from one decode slot to
    a training batch."""
    for arch in ARCHS:
        for getter in ("get", "get_smoke"):
            cfg = getattr(tconfigs, getter)(arch)
            for t in (1, 4, 64, 100, 410, 2048, 8192):
                want = max(jmoe._round_up(int(
                    cfg.capacity_factor * t * cfg.experts_per_tok
                    / cfg.n_experts), 128), 128)
                assert tmoe.moe_capacity(cfg, t) == want
    assert tmoe.moe_capacity(tconfigs.get("dbrx-132b"), 2048) == 640
    assert tmoe._round_up(129, 128) == jmoe._round_up(129, 128) == 256


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------
def _keep(x, router, cfg_t, k, e):
    """The port's keep mask for these inputs (the layer's own steps)."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ router.to(x.dtype)
    return tmoe._dispatch_indices(logits, k, e, tmoe.moe_capacity(cfg_t, t))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("skew,t", [(0.0, 40), (16.0, 160)],
                         ids=["fits", "overflow"])
def test_moe_layer_dense_matches_jax(dtype, skew, t):
    """The whole layer on exact inputs with tied router columns: the
    router logits, the rows kept and dropped, and the output row for row.
    With the skew, expert 0 is every token's choice (the all-zero tokens'
    by the tie rule): 160 of the T x k = 320 rows, capacity 128, so its
    last 32 rows are dropped; the same ones on both sides."""
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(int(skew) + t)
    x, p = _exact_inputs(rng, t, 4, 64, 96, skew)
    x = x.reshape(2, t // 2, 64)
    jx, jp, tx, tp = _both(x, p, dtype)
    jl = jx.reshape(t, 64) @ jp["router"].astype(jx.dtype)
    tl = tx.reshape(t, 64) @ tp["router"]
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl, np.float32))
    cap = tmoe.moe_capacity(tcfg, t)
    jd = jmoe._dispatch_indices(jl, 2, 4, cap)
    td = _keep(tx, tp["router"], tcfg, 2, 4)
    for got, want in zip(td[:3], jd[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = int((~td[2]).sum())
    assert dropped == (32 if skew else 0)
    want = np.asarray(jmoe.moe_layer_dense(jp, jx, jcfg), np.float32)
    got = tmoe.moe_layer_dense(tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    atol = ATOL if dtype == "f32" else BF16_ATOL * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_dropped_row_contributes_zero():
    """k == E with capacity factor 0.5: every token picks both experts,
    each expert takes the first 128 of the 200 tokens, and the last 72
    tokens, all of whose rows are dropped, come out exactly zero; the
    first 128 do not."""
    _, tcfg = _cfgs(e=2, k=2, cf=0.5)
    rng = np.random.RandomState(3)
    _, p = _exact_inputs(rng, 200, 2, 64, 96)
    x = rng.randn(1, 200, 64).astype(np.float32)
    _, _, tx, tp = _both(x, p, "f32")
    assert tmoe.moe_capacity(tcfg, 200) == 128
    out = tmoe.moe_layer_dense(tp, tx, tcfg)[0]
    assert torch.all(out[128:] == 0)
    assert bool(out[:128].abs().sum(1).gt(0).all())


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 40, 6).astype(np.float32)
    idx = rng.randint(0, 6, (120, 2)).astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits.reshape(120, 6)),
                                      jnp.asarray(idx), 6, 2)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits.reshape(120,
                                                                     6)),
                                     torch.from_numpy(idx).long(), 6, 2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_layer_grads_match_jax():
    """``jax.grad`` of a weighted sum of the layer's output, with
    overflow: the input's, the router's and the three banks' gradients
    (rtol 1e-4, atol 1e-5 of each one's largest magnitude: float32 sums
    over 128 capacity rows in another order)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(8)
    x, p = _exact_inputs(rng, 160, 4, 64, 96, skew=4.0)
    x = (x + rng.randn(160, 64).astype(np.float32) * 0.1).reshape(2, 80, 64)
    g = rng.randn(2, 80, 64).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmoe.moe_layer_dense(p, x, jcfg) * g)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    (tmoe.moe_layer_dense(tp, tx, tcfg) * torch.from_numpy(g)).sum() \
        .backward()
    for name, got, want in [("x", tx.grad, jgx)] + [
            (name, tp[name].grad, jgp[name]) for name in p]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert float(tp["router"].grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# Training through the MoE trunk
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_setup():
    out = {}
    for arch in ARCHS:
        # capacity factor 0.5: 128 rows an expert, as many as the 256
        # tokens' 512 rows give it on average, so experts overflow
        kw = dict(dtype="float32", capacity_factor=0.5)
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
        out[arch] = (jcfg, tcfg, jinit(jcfg, jax.random.key(1)))
    tokens = jsyn.token_stream(20_000, 320, seed=1)
    return out, tokens


def _paths(tree, prefix=""):
    """The leaves' paths, in the order of ``leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_grads_match_jax(train_setup, arch, remat):
    """Loss (atol 1e-5) and every gradient, the router's and the banks'
    among them (rtol 1e-4, atol 1e-6), against ``jax.value_and_grad`` of
    the reference's ``forward_train``; B 4 x S 64 at capacity factor 0.5:
    512 rows over 4 experts of capacity 128, so rows are dropped."""
    setups, tokens = train_setup
    jcfg, tcfg, jp = setups[arch]
    batch = next(jsyn.lm_batches(tokens, 4, 64, seed=4))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat=remat),
        has_aux=True)(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               trainable=True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = ttr.forward_train(tcfg, params, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves(params.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, jgrads))]
    names = _paths(params.tree())
    assert len(grads) == len(want) == len(names)
    for name, a, b in zip(names, grads, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert "blocks/moe/router" in names
    assert float(grads[names.index("blocks/moe/router")].abs().max()) > 0


def test_remat_recomputes_the_same_routing(train_setup, monkeypatch):
    """Under remat "full" every block runs twice (forward, then again in
    the backward): the recomputed routing is the forward's, call for
    call."""
    setups, tokens = train_setup
    jcfg, tcfg, jp = setups["phi3.5-moe-42b-a6.6b"]
    seen = []
    route = tmoe.route_topk

    def recording(logits, k):
        idx, w = route(logits, k)
        seen.append(idx.clone())
        return idx, w
    monkeypatch.setattr(tmoe, "route_topk", recording)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               trainable=True)
    batch = next(jsyn.lm_batches(tokens, 2, 64, seed=6))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = ttr.forward_train(tcfg, params, tb, remat="full")
    n = len(seen)
    assert n == tcfg.n_layers
    loss.backward()
    assert len(seen) == 2 * n
    # the backward recomputes the blocks last first
    for fwd, again in zip(seen[:n], reversed(seen[n:])):
        assert torch.equal(fwd, again)
