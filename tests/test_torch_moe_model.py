"""Port parity: the MoE decoders (phi3.5-moe-42b-a6.6b, dbrx-132b) against
the JAX package, on the CPU.

The parameter tree and counts; the slot and paged caches (the dense
decoder's ``k``/``v``); ``forward_prefill`` (float and int8) and
``forward_prefill_chunk`` in chunks of 4 then ``forward_decode`` with an
idle slot, within ``ATOL`` (float32 sums in another order); a chunk's pad
rows and a decode step's idle slots routed and counted toward the
experts' capacity as in the reference (the real rows' logits equal the
reference's, and differ where the pad rows or idle slots are left out);
one-shot prefill, ``grow_cache`` and decode against the continuous
engine; and the smoke configs in float32 served through the continuous,
static and paged engines (prefix hits, preemption), float, int8 and
calibrated int8, and from the deployment artifact, token-exact against
the JAX engines.  Both launchers with the smoke config on the CPU.
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
from repro.models import params as jparams
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import PagedBatchServer as JaxPaged
from repro.serve.server import StaticBatchServer as JaxStatic
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)

torch.set_num_threads(1)

ARCHS = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")
PHI, DBRX = ARCHS
ATOL = 1e-5


def _setup(arch, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    jp = jinit(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def setups():
    return {arch: _setup(arch, i) for i, arch in enumerate(ARCHS)}


def _leaves(leaf):
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def _assert_cache_close(jcache, tcache, atol=ATOL):
    assert sorted(tcache) == sorted(jcache)
    for key, jleaf in jcache.items():
        jl, tl = jax.tree.leaves(jleaf), _leaves(tcache[key])
        assert len(jl) == len(tl), key
        for a, t in zip(jl, tl):
            assert tuple(t.shape) == a.shape, key
            if key.endswith("_pos") or t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(a, np.float32),
                                           atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# Weights and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_counts_match_jax(setups, arch):
    """``init_params`` gives the JAX tree (each block's ``moe`` router
    (L, d, E) and banks (L, E, d, f) / (L, E, f, d), shapes and leaf
    kinds), ``params_from_numpy`` carries the banks across bit for bit,
    and the spec trees hold ``param_count`` parameters at full width."""
    jcfg, tcfg, jp, tp = setups[arch]
    jnp_tree = jax.tree.map(np.asarray, jp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jnp_tree):
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.detach().numpy(), leaf)
    init = tparams.init_params(tconfigs.get_smoke(arch),
                               torch.Generator().manual_seed(0), "cpu")
    moe = init["blocks"]["moe"]
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert moe["router"].shape == (2, d, e)
    assert moe["w_gate"].shape == moe["w_up"].shape == (2, e, d, f)
    assert moe["w_down"].shape == (2, e, f, d)
    assert moe["w_up"].dtype == torch.bfloat16
    assert sum(p.numel() for p in init.parameters()) == \
        jparams.param_count(jcfg)
    full = tconfigs.get(arch)
    specs = tparams.build_specs(full)
    count = sum(int(np.prod(s.shape)) for s in
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                    x, tparams.ParamSpec)))
    assert count == jparams.param_count(jconfigs.get(arch))
    assert tparams.layer_pattern(full) == {"kind": "uniform_moe",
                                           "n_layers": full.n_layers}


@pytest.mark.parametrize("policy", [None, "int8"])
def test_caches_match_jax(setups, policy):
    """Slot and paged decode caches: the dense decoder's leaves, shapes,
    dtypes, values and bytes; ``k``/``v`` are pooled."""
    jcfg, tcfg, _, _ = setups[DBRX]
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
    assert tkv.paged_cache_keys(tcfg) == ("k", "v")
    assert tkv.kv_cache_bytes(tcfg, 4, 576) == jkv.kv_cache_bytes(jcfg, 4,
                                                                  576)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision", [(PHI, None), (DBRX, None),
                                            (PHI, "int8")])
def test_forward_prefill_matches_jax(setups, arch, precision):
    """One-shot prefill of 2 x 13 tokens: the last-token logits and every
    cache leaf; under int8 the attention projections quantized (the
    experts float) and the K/V ``Int8KV``."""
    jcfg, tcfg, jp, tp = setups[arch]
    tok = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jpol = None if precision is None else jq.policy_for(precision)
    tpol = None if precision is None else tq.policy_for(precision)
    jw = jp if jpol is None else jq.quantize_model_params(jp, jpol)
    tw = tp if tpol is None else tq.quantize_model_params(tp, tpol)
    jl, jcache = jtr.forward_prefill(jcfg, jw, {"tokens": jnp.asarray(tok)},
                                     jpol)
    tl, tcache = ttr.forward_prefill(tcfg, tw,
                                     {"tokens": torch.from_numpy(tok)}, tpol)
    atol = ATOL if precision is None else 1e-4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    _assert_cache_close(jcache, tcache, atol)


def _chunk(prompt, p, c):
    real = min(c, len(prompt) - p)
    toks = np.zeros((1, c), np.int32)
    poss = np.full((1, c), -1, np.int32)
    toks[0, :real] = prompt[p:p + real]
    poss[0, :real] = np.arange(p, p + real)
    return toks, poss, np.array([p + c], np.int32), real


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_and_decode_match_jax(setups, arch):
    """Prompts of 13 and 7 tokens, each prefilled in chunks of 4 (the last
    one ragged) into its own slot, then two decode steps over three slots
    with slot 2 idle (``kv_len`` 0): the logits of every real row, and
    the caches after the prefill and after the decode."""
    jcfg, tcfg, jp, tp = setups[arch]
    rng = np.random.RandomState(4)
    jcaches = [jkv.alloc_decode_cache(jcfg, 1, 32) for _ in range(3)]
    tcaches = [tkv.alloc_decode_cache(tcfg, 1, 32, "cpu") for _ in range(3)]
    for slot, n in ((0, 13), (1, 7)):
        prompt = rng.randint(0, jcfg.vocab_size, n).astype(np.int32)
        for p in range(0, n, 4):
            toks, poss, kvl, real = _chunk(prompt, p, 4)
            jl, jcaches[slot] = jtr.forward_prefill_chunk(
                jcfg, jp, jcaches[slot], jnp.asarray(toks),
                jnp.asarray(poss), kv_len=jnp.asarray(kvl))
            tl, _ = ttr.forward_prefill_chunk(
                tcfg, tp, tcaches[slot], torch.from_numpy(toks),
                torch.from_numpy(poss), kv_len=torch.from_numpy(kvl))
            np.testing.assert_allclose(tl.numpy()[0, :real],
                                       np.asarray(jl)[0, :real], atol=ATOL)
    jcache = {key: jnp.concatenate([c[key] for c in jcaches], axis)
              for key, axis in _SLOT_AXES.items()}
    tcache = {key: torch.cat([c[key] for c in tcaches], axis)
              for key, axis in _SLOT_AXES.items()}
    _assert_cache_close(jcache, tcache)
    for t in range(2):
        tok = rng.randint(0, jcfg.vocab_size, 3).astype(np.int32)
        pos = np.array([13 + t, 7 + t, 0], np.int32)
        kvl = np.array([14 + t, 8 + t, 0], np.int32)
        jl, jcache = jtr.forward_decode(jcfg, jp, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos),
                                        kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_decode(tcfg, tp, tcache,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(pos),
                                        kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=ATOL)
    _assert_cache_close(jcache, tcache)


# the slot axis of each cache leaf: K/V (L, B, S, ...), positions (B, S)
_SLOT_AXES = {"k": 1, "v": 1, "full_pos": 0}


def _drops(monkeypatch):
    """Record the rows each ``moe_layer`` call drops."""
    drops = []
    dispatch = tmoe._dispatch_indices

    def recording(*args):
        out = dispatch(*args)
        drops.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(tmoe, "_dispatch_indices", recording)
    return drops


def test_pad_rows_take_capacity(setups, monkeypatch):
    """A chunk of 256 whose 200 real rows repeat one token: they route
    alike, and an expert's capacity at T = 256 (the chunk with its 56 pad
    rows, 256 a expert) holds them all.  The real rows' logits equal the
    reference's; the same 200 rows as a chunk of 200 (T = 200, capacity
    128) drop rows, and their logits differ."""
    jcfg, tcfg, jp, tp = setups[PHI]
    prompt = np.full(200, 5, np.int32)
    drops = _drops(monkeypatch)
    logits = {}
    for c in (256, 200):
        toks, poss, kvl, real = _chunk(prompt, 0, c)
        tl, _ = ttr.forward_prefill_chunk(
            tcfg, tp, tkv.alloc_decode_cache(tcfg, 1, 256, "cpu"),
            torch.from_numpy(toks), torch.from_numpy(poss),
            kv_len=torch.from_numpy(kvl))
        logits[c] = tl[0, :real].numpy()
    jl, _ = jtr.forward_prefill_chunk(
        jcfg, jp, jkv.alloc_decode_cache(jcfg, 1, 256),
        *(jnp.asarray(a) for a in _chunk(prompt, 0, 256)[:2]),
        kv_len=jnp.asarray(np.array([256], np.int32)))
    np.testing.assert_allclose(logits[256], np.asarray(jl)[0, :200],
                               atol=ATOL)
    n = tcfg.n_layers
    assert sum(drops[:n]) == 0 and sum(drops[n:]) > 0
    assert np.abs(logits[200] - logits[256]).max() > 1e-3


def test_idle_slots_take_capacity(setups, monkeypatch):
    """A decode step over 160 slots, the first 120 idle (token 0, kv_len
    0, as the engines leave them) and 40 live at position 0: T = 160, 128
    rows an expert, and the idle rows, all routed to the same two
    experts, take 120 of those first, so live rows are dropped.  The live
    rows' logits equal the reference's, and differ from the same 40 slots
    decoded alone."""
    jcfg, tcfg, jp, tp = setups[PHI]
    rng = np.random.RandomState(7)
    live = rng.randint(1, jcfg.vocab_size, 40).astype(np.int32)
    tok = np.concatenate([np.zeros(120, np.int32), live])
    kvl = np.concatenate([np.zeros(120, np.int32), np.ones(40, np.int32)])
    pos = np.zeros(160, np.int32)
    drops = _drops(monkeypatch)
    tl, _ = ttr.forward_decode(
        tcfg, tp, tkv.alloc_decode_cache(tcfg, 160, 8, "cpu"),
        torch.from_numpy(tok), torch.from_numpy(pos),
        kv_len=torch.from_numpy(kvl))
    jl, _ = jtr.forward_decode(jcfg, jp, jkv.alloc_decode_cache(jcfg, 160, 8),
                               jnp.asarray(tok), jnp.asarray(pos),
                               kv_len=jnp.asarray(kvl))
    np.testing.assert_allclose(tl[120:].numpy(), np.asarray(jl)[120:],
                               atol=ATOL)
    assert sum(drops) > 0
    alone, _ = ttr.forward_decode(
        tcfg, tp, tkv.alloc_decode_cache(tcfg, 40, 8, "cpu"),
        torch.from_numpy(live), torch.from_numpy(pos[:40]),
        kv_len=torch.from_numpy(kvl[120:]))
    assert float((alone - tl[120:]).abs().max()) > 1e-3


def test_prefill_grow_decode_equals_continuous(setups):
    """One-shot prefill, ``grow_cache`` and greedy decode give the tokens
    of the continuous engine serving the same prompt (no row is dropped
    at these sizes)."""
    _, tcfg, _, tp = setups[DBRX]
    prompt = np.random.RandomState(9).randint(0, tcfg.vocab_size, 11) \
        .astype(np.int32)
    logits, cache = ttr.forward_prefill(
        tcfg, tp, {"tokens": torch.from_numpy(prompt[None])})
    cache = ttr.grow_cache(tcfg, cache, 8)
    assert cache["k"].shape[2] == 19 and cache["full_pos"].shape == (1, 19)
    out = [int(logits[0].argmax())]
    for t in range(5):
        lg, cache = ttr.forward_decode(
            tcfg, tp, cache, torch.tensor([out[-1]], dtype=torch.int32),
            torch.tensor([11 + t], dtype=torch.int32))
        out.append(int(lg[0].argmax()))
    srv = ContinuousBatchServer(tcfg, tp, slots=1, max_prompt=16,
                                prefill_chunk=4, max_new_tokens=6,
                                device="cpu")
    req, = srv.submit([prompt])
    srv.run()
    assert out == req.tokens


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


_KW = dict(slots=2, max_prompt=24, max_new_tokens=12, prefill_chunk=4)
# host reads a CUDA graph cannot capture
HOST_READS = ("aten.item", "aten._local_scalar_dense", "aten.nonzero")


@pytest.mark.parametrize("arch,precision", [(PHI, "float"), (DBRX, "float"),
                                            (PHI, "int8"),
                                            (DBRX, "int8_fakequant")])
def test_continuous_serving_matches_jax(setups, arch, precision):
    jcfg, tcfg, jp, tp = setups[arch]
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_KW, precision=precision)
    want, jm = _run(JaxServer(jcfg, jp, **kw), prompts, budgets)
    got, tm = _run(ContinuousBatchServer(tcfg, tp, device="cpu", **kw),
                   prompts, budgets)
    assert got == want
    assert (tm["decode_steps"], tm["prefill_chunks"]) == \
        (jm["decode_steps"], jm["prefill_chunks"])
    assert tm["kv_cache_bytes"] == jm["kv_cache_bytes"]


def test_static_serving_matches_jax(setups):
    jcfg, tcfg, jp, tp = setups[DBRX]
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(batch_size=2, max_prompt=24, prefill_chunk=4,
              max_new_tokens=12)
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


def _prefix_workload(vocab):
    """Three prompts near the slot capacity, then three that share a
    16-token prefix (two full blocks of 8)."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (14, 15, 13)]
    base = rng.randint(0, vocab, 16).astype(np.int32)
    prompts += [np.concatenate([base, rng.randint(0, vocab, n)
                                .astype(np.int32)]) for n in (1, 3, 2)]
    return prompts, [12, 10, 12, 5, 6, 4]


_PAGED_KW = dict(slots=3, max_prompt=20, prefill_chunk=4,
                 max_new_tokens=12, block_size=8, pool_blocks=8)


@pytest.mark.parametrize("arch,precision", [(PHI, "float"), (DBRX, "int8")])
def test_paged_serving_matches_jax(setups, arch, precision):
    """A pool of 8 blocks for 3 slots preempts, and the shared prefix
    hits the prefix cache (shared as the reference shares it): tokens,
    preemptions, prefix hits and step counts equal the JAX paged
    engine's."""
    jcfg, tcfg, jp, tp = setups[arch]
    prompts, budgets = _prefix_workload(tcfg.vocab_size)
    kw = dict(_PAGED_KW, precision=precision)
    want, jm = _run(_SyncedJaxPaged(jcfg, jp, **kw), prompts, budgets)
    srv = PagedBatchServer(tcfg, tp, device="cpu", **kw)
    got, tm = _run(srv, prompts, budgets)
    assert got == want
    assert srv.manager.prefix_cache
    assert tm["preemptions"] >= 1 and tm["prefix_hit_blocks"] >= 1
    for key in ("preemptions", "prefix_hit_blocks", "decode_steps",
                "prefill_chunks", "kv_cache_bytes"):
        assert tm[key] == jm[key], key


_AMAX = {"wq": 4.0, "wk": 4.0, "wv": 4.0, "wo": 4.0}


def test_calibrated_serving_matches_jax(setups):
    """Calibrated int8 activations: an amax a projection scope on the
    quantized tree (the experts float, no amax); the continuous engine
    gives the JAX engine's tokens with the same amax."""
    jcfg, tcfg, jp, tp = setups[PHI]
    jcal = dataclasses.replace(jq.INT8, activations="calibrated")
    tcal = dataclasses.replace(tq.INT8, activations="calibrated")
    qp = tq.attach_act_amax(tq.quantize_model_params(tp, tq.INT8), _AMAX)
    assert float(qp["blocks"]["attn"]["wo"].amax[1]) == 4.0
    assert not isinstance(qp["blocks"]["moe"]["w_down"], tq.QTensor)
    prompts, budgets = _workload(tcfg.vocab_size)
    jsrv = JaxServer(jcfg, jp, precision=jcal, **_KW)
    jsrv.params = jq.attach_act_amax(jsrv.params, _AMAX)
    want, _ = _run(jsrv, prompts, budgets)
    got, _ = _run(ContinuousBatchServer(tcfg, qp, precision=tcal,
                                        device="cpu", **_KW),
                  prompts, budgets)
    assert got == want


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_use_artifact_matches_eager_and_jax(setups, engine):
    """The MoE decode step exported (``compile_serve_decode``: no host
    read in the routing, or the export fails) and replayed: the eager
    engine's tokens, which are the JAX engine's."""
    jcfg, tcfg, jp, tp = setups[DBRX]
    prompts, budgets = _workload(tcfg.vocab_size)
    cls, jcls = ((ContinuousBatchServer, JaxServer) if engine == "continuous"
                 else (PagedBatchServer, _SyncedJaxPaged))
    want, _ = _run(jcls(jcfg, jp, **_KW), prompts, budgets)
    eager, _ = _run(cls(tcfg, tp, device="cpu", **_KW), prompts, budgets)
    srv = cls(tcfg, tp, device="cpu", use_artifact=True, **_KW)
    got, tm = _run(srv, prompts, budgets)
    assert got == eager == want
    assert srv.artifact is not None and tm["artifact_bytes"] > 0
    targets = {str(n.target) for n in srv.artifact.program().graph.nodes
               if n.op == "call_function"}
    assert not any(t.startswith(HOST_READS) for t in targets), targets
    assert "aten.sort.stable" in targets


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train(arch, monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.launch.serve --arch <moe>`` (paged, int8)
    and ``python -m repro_torch.launch.train --arch <moe>`` with remat
    full, the smoke config on the CPU."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "3",
        "--slots", "2", "--prompt-len", "9", "--max-new", "4",
        "--engine", "paged", "--precision", "int8"])
    tlaunch.main()
    assert '"requests": 3' in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--remat", "full", "--ckpt-dir",
        str(tmp_path / "ck")])
    tlaunch_train.main()
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out
