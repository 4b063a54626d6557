"""Port parity: the hybrid trunk of zamba2-2.7b (groups of mamba2 blocks,
each closed by one shared attention block) against the JAX package, on
the CPU.

The config and parameter counts (full and smoke); the ``groups`` /
``shared_attn`` parameter tree carried across leaf for leaf; the slot and
paged caches (the SSM state slot-addressed and stacked (groups, group,
B, ...), the shared block's K/V one leaf an application, pooled when
paged); ``forward_prefill``, ``forward_prefill_chunk`` in chunks of 1, 4
and 16 and ``forward_decode`` within ``ATOL`` (float32 sums in another
order); and the smoke config in float32 served through the continuous,
static and paged engines, float, int8 and int8 with calibrated
activations on the shared block, and from the deployment artifact,
token-exact against the JAX engines.  Training: ``forward_train``'s
loss and gradients against ``jax.value_and_grad`` of the reference's.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.models import api as japi
from repro.models import params as jparams
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import PagedBatchServer as JaxPaged
from repro.serve.server import StaticBatchServer as JaxStatic
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.core.tree import leaves
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _spec_count(tree) -> int:
    return sum(_spec_count(v) if isinstance(v, dict)
               else int(np.prod(v.shape)) for v in tree.values())


def _leaves(leaf):
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def _assert_cache_close(jcache, tcache, atol=ATOL):
    assert sorted(tcache) == sorted(jcache)
    for key, jleaf in jcache.items():
        jl, tl = jax.tree.leaves(jleaf), _leaves(tcache[key])
        assert len(jl) == len(tl), key
        for a, t in zip(jl, tl):
            assert tuple(t.shape) == a.shape, key
            assert str(t.dtype).removeprefix("torch.") == str(a.dtype), key
            if key.endswith("_pos") or t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(a, np.float32),
                                           atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# Config, weights, caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("getter", ["get", "get_smoke"])
def test_config_and_param_counts_match_jax(getter):
    """``configs.get`` no longer raises; the full config (54 layers, 9
    groups of 6, 32/32 heads of 80) and the smoke config are the JAX
    package's, and the spec trees hold ``param_count`` parameters
    (2,342,681,760 at full width)."""
    jc, tc = getattr(jconfigs, getter)(ARCH), getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tconfigs.comes_with(ARCH) is None
    assert _spec_count(tparams.build_specs(tc)) == jparams.param_count(jc)
    assert tc.param_count() == jc.param_count()
    if getter == "get":
        assert jparams.param_count(jc) == 2_342_681_760
        assert tc.resolved_head_dim == 80
        assert tparams.layer_pattern(tc) == {"kind": "hybrid", "group": 6,
                                             "n_groups": 9}


def test_hybrid_params_match_jax(setup):
    """The ``groups`` (n_groups, group, ...) mamba2 tree and the unstacked
    ``shared_attn`` block carry across leaf for leaf; the nested per-layer
    views are the stacked leaves' slices; ``init_params`` draws the same
    tree."""
    jcfg, tcfg, jp, tp = setup
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.detach().numpy(), leaf)
    groups = tp["groups"].unstack(2)
    assert len(groups) == 2 and len(groups[0]) == 3
    assert torch.equal(groups[1][2]["mamba"]["in_proj"],
                       tp["groups"]["mamba"]["in_proj"][1, 2])
    assert tp["shared_attn"]["attn"]["wq"].shape == (64, 64)
    init = tparams.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in init.parameters()) == \
        jparams.param_count(jcfg)


@pytest.mark.parametrize("policy", [None, "int8"])
def test_caches_match_jax(setup, policy):
    """Slot and paged decode caches: the same leaves, shapes, dtypes and
    empty values as the JAX package's, and the same bytes; the SSM state
    stays slot-addressed in the paged cache, only ``attn_k``/``attn_v``
    are pooled."""
    jcfg, tcfg, _, _ = setup
    jpol = None if policy is None else jq.policy_for(policy)
    tpol = None if policy is None else tq.policy_for(policy)
    for jcache, tcache in (
            (jkv.alloc_decode_cache(jcfg, 3, 40, jpol),
             tkv.alloc_decode_cache(tcfg, 3, 40, "cpu", tpol)),
            (jkv.alloc_paged_cache(jcfg, 2, 64, 5, jpol, 8),
             tkv.alloc_paged_cache(tcfg, 2, 64, 5, "cpu", tpol, 8))):
        assert set(tcache) == set(jcache)
        for key, jleaf in jcache.items():
            for a, t in zip(jax.tree.leaves(jleaf), _leaves(tcache[key])):
                assert tuple(t.shape) == a.shape, key
                assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(a, np.float32))
        assert tkv.decode_cache_nbytes(tcache) == \
            jkv.decode_cache_nbytes(jcache)
    assert tkv.paged_cache_keys(tcfg) == ("attn_k", "attn_v")
    assert tkv.kv_pool_block_bytes(tcfg, 64, tpol, 8) == \
        jkv.kv_pool_block_bytes(jcfg, 64, jpol, 8)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", [None, "int8"])
def test_forward_prefill_matches_jax(setup, precision):
    """One-shot prefill: the last-token logits and the whole cache (the
    groups' SSM states, each application's K/V, positions), leaf for leaf;
    under int8 the weights quantized and the K/V ``Int8KV``."""
    jcfg, tcfg, jp, tp = setup
    tok = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jpol = None if precision is None else jq.policy_for(precision)
    tpol = None if precision is None else tq.policy_for(precision)
    jw = jp if jpol is None else jq.quantize_model_params(jp, jpol)
    tw = tp if tpol is None else tq.quantize_model_params(tp, tpol)
    jl, jcache = japi.model_fns(jcfg).forward_prefill(
        jcfg, jw, {"tokens": jnp.asarray(tok)}, jpol)
    tl, tcache = tapi.model_fns(tcfg).forward_prefill(
        tcfg, tw, {"tokens": torch.from_numpy(tok)}, tpol)
    atol = ATOL if precision is None else 1e-4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    _assert_cache_close(jcache, tcache, atol)


# the slot axis of each hybrid cache leaf: the SSM state (groups, group,
# B, ...), the shared block's K/V (groups, B, S, ...), positions (B, S)
_SLOT_AXES = {"ssm": 2, "attn_k": 1, "attn_v": 1, "full_pos": 0}


def _join(caches, cat):
    """One cache of the batch-1 caches' slots, in order."""
    out = {}
    for key, axis in _SLOT_AXES.items():
        leaves = [c[key] for c in caches]
        if isinstance(leaves[0], tuple):
            out[key] = type(leaves[0])(*(cat(list(t), axis)
                                         for t in zip(*leaves)))
        else:
            out[key] = cat(leaves, axis)
    return out


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_prefill_chunks_and_decode_match_jax(setup, chunk):
    """Prompts of 13 and 7 tokens, each prefilled chunk by chunk into its
    own slot (the last chunk ragged), then two decode steps over both
    slots with slot 1 idle (``kv_len`` 0): the logits of every real row,
    and the caches after the prefill and after the decode; the idle
    slot's state is untouched."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(chunk)
    jcaches, tcaches = [], []
    for n in (13, 7):
        prompt = rng.randint(0, jcfg.vocab_size, n).astype(np.int32)
        jcache = jkv.alloc_decode_cache(jcfg, 1, 32)
        tcache = tkv.alloc_decode_cache(tcfg, 1, 32, "cpu")
        for p in range(0, n, chunk):
            real = min(chunk, n - p)
            toks = np.zeros((1, chunk), np.int32)
            poss = np.full((1, chunk), -1, np.int32)
            toks[0, :real] = prompt[p:p + real]
            poss[0, :real] = np.arange(p, p + real)
            kvl = np.array([p + chunk], np.int32)
            jl, jcache = jtr.forward_prefill_chunk(
                jcfg, jp, jcache, jnp.asarray(toks), jnp.asarray(poss),
                kv_len=jnp.asarray(kvl))
            tl, tcache = ttr.forward_prefill_chunk(
                tcfg, tp, tcache, torch.from_numpy(toks),
                torch.from_numpy(poss), kv_len=torch.from_numpy(kvl))
            np.testing.assert_allclose(tl.numpy()[0, :real],
                                       np.asarray(jl)[0, :real], atol=ATOL)
        _assert_cache_close(jcache, tcache)
        jcaches.append(jcache)
        tcaches.append(tcache)
    jcache = _join(jcaches, lambda ts, a: jnp.concatenate(ts, a))
    tcache = _join(tcaches, lambda ts, a: torch.cat(ts, a))
    before = [t.clone() for t in tcache["ssm"]]
    for t in range(2):
        tok = rng.randint(0, jcfg.vocab_size, 2).astype(np.int32)
        pos = np.array([13 + t, 7], np.int32)
        kvl = np.array([14 + t, 0], np.int32)
        jl, jcache = jtr.forward_decode(jcfg, jp, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos),
                                        kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_decode(tcfg, tp, tcache,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(pos),
                                        kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                                   atol=ATOL)
    _assert_cache_close(jcache, tcache)
    for new, old in zip(tcache["ssm"], before):
        assert torch.equal(new[:, :, 1], old[:, :, 1])
        assert not torch.equal(new[:, :, 0], old[:, :, 0])


def test_prefill_grow_decode_equals_chunked(setup):
    """One-shot prefill, ``grow_cache`` (the shared block's K/V grow, the
    states keep their size) and greedy decode give the tokens of the
    continuous engine serving the same prompt."""
    _, tcfg, _, tp = setup
    prompt = np.random.RandomState(9).randint(0, tcfg.vocab_size, 11) \
        .astype(np.int32)
    fns = tapi.model_fns(tcfg)
    logits, cache = fns.forward_prefill(
        tcfg, tp, {"tokens": torch.from_numpy(prompt[None])})
    cache = ttr.grow_cache(tcfg, cache, 8)
    assert cache["attn_k"].shape[2] == 19 and cache["full_pos"].shape == \
        (1, 19)
    out = [int(logits[0].argmax())]
    for t in range(5):
        lg, cache = fns.forward_decode(
            tcfg, tp, cache, torch.tensor([out[-1]], dtype=torch.int32),
            torch.tensor([11 + t], dtype=torch.int32))
        out.append(int(lg[0].argmax()))
    srv = ContinuousBatchServer(tcfg, tp, slots=1, max_prompt=16,
                                prefill_chunk=4, max_new_tokens=6,
                                device="cpu")
    req, = srv.submit([prompt])
    srv.run()
    assert out == req.tokens


def test_training_runs_and_matches_jax(setup):
    """Under autograd the hybrid trunk trains (the SSD layer by autograd,
    the shared block through the attention's backward): loss (atol 1e-5)
    and every gradient (rtol 1e-4, atol 1e-6) against ``jax.value_and_grad``
    of the reference's ``forward_train``, remat "full"; without autograd
    the same forward runs (one-shot prefill)."""
    jcfg, tcfg, jp, _ = setup
    tok = np.random.RandomState(3).randint(0, tcfg.vocab_size, (1, 8)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat="full"),
        has_aux=True)(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    tt = torch.from_numpy(tok)
    loss, _ = ttr.forward_train(tcfg, tp, {"tokens": tt, "labels": tt})
    grads = torch.autograd.grad(loss, leaves(tp.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    with torch.no_grad():
        x, _ = ttr.trunk_forward(tcfg, tp, ttr.embed_tokens(tp, tt, tcfg),
                                 ttr.default_positions(1, 8))
    assert x.shape == (1, 8, tcfg.d_model)


# ---------------------------------------------------------------------------
# Serving: token-exact against the JAX engines
# ---------------------------------------------------------------------------
def _workload(vocab):
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (3, 11, 7, 21)]
    return prompts, [5, 12, 6, 3]


def _run(engine, prompts, budgets):
    reqs = engine.submit(prompts, max_new_tokens=budgets)
    metrics = engine.run()
    return [r.tokens for r in reqs], metrics


_KW = dict(slots=2, max_prompt=24, max_new_tokens=12)


@pytest.mark.parametrize("precision,chunk", [("float", 1), ("float", 4),
                                             ("float", 16), ("int8", 4)])
def test_continuous_serving_matches_jax(setup, precision, chunk):
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_KW, prefill_chunk=chunk, precision=precision)
    want, jm = _run(JaxServer(jcfg, jp, **kw), prompts, budgets)
    got, tm = _run(ContinuousBatchServer(tcfg, tp, device="cpu", **kw),
                   prompts, budgets)
    assert got == want
    assert (tm["decode_steps"], tm["prefill_chunks"]) == \
        (jm["decode_steps"], jm["prefill_chunks"])
    assert tm["kv_cache_bytes"] == jm["kv_cache_bytes"]


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_static_serving_matches_jax(setup, precision):
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(batch_size=2, max_prompt=24, prefill_chunk=4,
              max_new_tokens=12, precision=precision)
    want, _ = _run(JaxStatic(jcfg, jp, **kw), prompts, budgets)
    got, _ = _run(StaticBatchServer(tcfg, tp, device="cpu", **kw), prompts,
                  budgets)
    assert got == want


class _SyncedJaxPaged(JaxPaged):
    """The JAX paged engine with each chunk step waited for (the race of
    ``tests/test_torch_paged.py::_SyncedJaxPaged``)."""

    def _chunk_call(self, slot, toks, poss, kvl):
        return jax.block_until_ready(
            super()._chunk_call(slot, toks, poss, kvl))


# 3 slots of 4 blocks of 8 over a pool of 7: preemption, states rebuilt
_PAGED_KW = dict(slots=3, max_prompt=24, prefill_chunk=4, max_new_tokens=12,
                 block_size=8, pool_blocks=7)


def test_paged_serving_matches_jax(setup):
    """Float: a pool too small for the three slots preempts, and the
    re-prefill rebuilds the evicted slot's SSM states; tokens, preemptions
    and step counts equal the JAX paged engine's.  Prefix sharing is off
    for the hybrid trunk (shared prompts, no hit)."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    prompts = prompts + [prompts[3].copy(), prompts[3][:18].copy()]
    budgets = budgets + [8, 10]
    want, jm = _run(_SyncedJaxPaged(jcfg, jp, **_PAGED_KW), prompts, budgets)
    srv = PagedBatchServer(tcfg, tp, device="cpu", **_PAGED_KW)
    got, tm = _run(srv, prompts, budgets)
    assert got == want
    assert tm["preemptions"] == jm["preemptions"] > 0
    assert tm["prefix_hit_blocks"] == jm["prefix_hit_blocks"] == 0
    assert not srv.manager.prefix_cache
    assert (tm["decode_steps"], tm["prefill_chunks"]) == \
        (jm["decode_steps"], jm["prefill_chunks"])


def test_paged_int8_matches_jax_continuous(setup):
    """int8 paged serving, preempting: the JAX continuous engine's tokens,
    and the schedule of the port's own float paged run."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_PAGED_KW, precision="int8")
    cont = {k: v for k, v in kw.items()
            if k not in ("block_size", "pool_blocks")}
    want, _ = _run(JaxServer(jcfg, jp, **cont), prompts, budgets)
    got, tm = _run(PagedBatchServer(tcfg, tp, device="cpu", **kw), prompts,
                   budgets)
    assert got == want
    _, fm = _run(PagedBatchServer(tcfg, tp, device="cpu", **_PAGED_KW),
                 prompts, budgets)
    for key in ("preemptions", "decode_steps", "prefill_chunks"):
        assert tm[key] == fm[key], key


_AMAX = {"wq": 4.0, "wk": 4.0, "wv": 4.0, "wo": 4.0, "w_gate": 4.0,
         "w_up": 4.0, "w_down": 8.0}


def test_calibrated_shared_block_matches_jax(setup):
    """``quantize_model_params`` and ``attach_act_amax`` on the hybrid
    tree: the shared block's projections become 2-D ``QTensor``s with one
    amax each (one set, applied nine times a step at full width), the
    mamba2 blocks stay float; the calibrated continuous engine gives the
    JAX engine's tokens with the same amax."""
    jcfg, tcfg, jp, tp = setup
    jcal = dataclasses.replace(jq.INT8, activations="calibrated")
    tcal = dataclasses.replace(tq.INT8, activations="calibrated")
    qp = tq.attach_act_amax(tq.quantize_model_params(tp, tq.INT8), _AMAX)
    wq = qp["shared_attn"]["attn"]["wq"]
    assert isinstance(wq, tq.QTensor) and wq.q.dim() == 2
    assert wq.amax.shape == () and float(wq.amax) == 4.0
    assert float(qp["shared_attn"]["mlp"]["w_down"].amax) == 8.0
    mamba = qp["groups"]["mamba"]
    assert isinstance(mamba["in_proj"], torch.Tensor)
    assert mamba["in_proj"].is_floating_point()
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_KW, prefill_chunk=4)
    jsrv = JaxServer(jcfg, jp, precision=jcal, **kw)
    jsrv.params = jq.attach_act_amax(jsrv.params, _AMAX)
    want, _ = _run(jsrv, prompts, budgets)
    got, _ = _run(ContinuousBatchServer(tcfg, qp, precision=tcal,
                                        device="cpu", **kw),
                  prompts, budgets)
    assert got == want


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_use_artifact_matches_jax_eager(setup, engine):
    """The decode step exported (``compile_serve_decode``) on the hybrid
    cache and replayed: the JAX eager engine's tokens (the JAX package
    cannot serialize an ``SSMState``, so its artifact engine is not the
    yardstick here)."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_KW, prefill_chunk=4)
    want, _ = _run(JaxServer(jcfg, jp, **kw), prompts, budgets)
    cls = ContinuousBatchServer if engine == "continuous" \
        else PagedBatchServer
    srv = cls(tcfg, tp, device="cpu", use_artifact=True, **kw)
    got, _ = _run(srv, prompts, budgets)
    assert got == want
    assert srv.artifact is not None


def test_launcher_serves_zamba2(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch zamba2-2.7b`` (the smoke
    config on the CPU) serves every request."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--device", "cpu", "--requests", "3",
        "--slots", "2", "--prompt-len", "9", "--max-new", "4"])
    tlaunch.main()
    out = capsys.readouterr().out
    assert '"requests": 3' in out
