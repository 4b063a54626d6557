"""Port parity: the sliding-window ring of the local:global trunk
(gemma3-4b) and the configs of slice 7, against the JAX package, on the
CPU.

The ring helpers bitwise (``ring_scatter_idx``, the in-place
``ring_scatter``, ``_ring_select``, ``_ring_from_prefill``); the
``local_global`` parameter tree and the full configs' parameter counts;
the decode and paged caches' layouts; and gemma3 served through the
continuous, static and paged engines, float and int8, in chunks of 1, 4
and 16, token-exact against the JAX engines on prompts that wrap the
smoke config's window of 8.  The JAX ``PagedBatchServer`` is never built
on gemma3 in int8 (XLA's compiler crashes there, ``ROADMAP.md`` queue 3):
those runs are held against the JAX continuous engine, and their paged
schedule against the port's own float paged run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import PagedBatchServer as JaxPaged
from repro.serve.server import StaticBatchServer as JaxStatic
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)

torch.set_num_threads(1)

ARCH = "gemma3-4b"
SLICE7 = ("granite-3-8b", "llama3.2-3b", "gemma3-4b")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# Ring helpers, bitwise
# ---------------------------------------------------------------------------
def _chunk_positions():
    """(B, C) chunk positions: a full chunk, a ragged one (pad tail −1),
    one longer than the window, one starting mid-stream."""
    pos = np.full((4, 12), -1, np.int32)
    pos[0] = np.arange(12)
    pos[1, :5] = np.arange(3, 8)
    pos[2] = np.arange(20, 32)
    pos[3, :9] = np.arange(100, 109)
    return pos


@pytest.mark.parametrize("window", [4, 8, 16])
def test_ring_scatter_matches_jax(window):
    """The chunk's ring targets, and the in-place scatter of values and
    positions into a ring that already holds entries: bitwise."""
    pos = _chunk_positions()
    jidx = np.asarray(jlayers.ring_scatter_idx(jnp.asarray(pos), window))
    tidx = tlayers.ring_scatter_idx(torch.from_numpy(pos), window)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    rng = np.random.RandomState(window)
    ring = rng.randn(4, window, 2, 3).astype(np.float32)
    new = rng.randn(4, 12, 2, 3).astype(np.float32)
    want = np.asarray(jlayers._ring_scatter(jnp.asarray(ring),
                                            jnp.asarray(new),
                                            jnp.asarray(jidx)))
    got = torch.from_numpy(ring.copy())
    tlayers.ring_scatter(got, torch.from_numpy(new), tidx)
    np.testing.assert_array_equal(got.numpy(), want)
    # nothing kept (an all-pad row): the ring is unchanged
    before = got.clone()
    tlayers.ring_scatter(got, torch.from_numpy(new),
                         torch.full((4, 12), window, dtype=torch.int32))
    assert torch.equal(got, before)


@pytest.mark.parametrize("window", [4, 32])
def test_ring_select_and_gather_match_jax(window):
    """``_ring_select``'s placement (source rows, filled rows, ring
    positions) and ``_ring_from_prefill``'s gather over stacked leaves,
    with left-padded rows: bitwise."""
    pos = np.full((3, 20), -1, np.int32)
    pos[0] = np.arange(20)
    pos[1, 7:] = np.arange(13)
    pos[2, 17:] = np.arange(3)
    j = jtr._ring_select(jnp.asarray(pos), window)
    t = ttr._ring_select(torch.from_numpy(pos), window)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    k = np.random.RandomState(1).randn(2, 3, 3, 20, 2, 4).astype(np.float32)
    want = jtr._ring_from_prefill(jnp.asarray(k), j[0], j[1])
    got = ttr._ring_from_prefill(torch.from_numpy(k), t[0], t[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Configs, parameters, caches
# ---------------------------------------------------------------------------
def _spec_count(tree) -> int:
    return sum(_spec_count(v) if isinstance(v, dict)
               else int(np.prod(v.shape)) for v in tree.values())


@pytest.mark.parametrize("arch", SLICE7)
def test_full_configs_and_param_counts_match_jax(arch):
    """``configs.get`` gives the JAX package's full config, and its spec
    tree holds exactly ``repro.models.params.param_count`` parameters
    (gemma3: 3.9 B, granite: 8.2 B, llama3.2: 3.2 B)."""
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tconfigs.comes_with(arch) is None
    assert _spec_count(tparams.build_specs(tc)) == jparams.param_count(jc)
    assert tc.param_count() == jc.param_count()


def test_local_global_params_match_jax(setup):
    """The ``groups.local`` (groups, ratio, ...) / ``groups.global`` /
    ``tail_local`` tree carries across leaf for leaf, and the nested
    per-layer views are the stacked leaves' slices."""
    jcfg, tcfg, jp, tp = setup
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.detach().numpy(), leaf)
    local = tp["groups"]["local"].unstack(2)
    assert len(local) == 1 and len(local[0]) == 5
    assert torch.equal(local[0][3]["attn"]["wq"],
                       tp["groups"]["local"]["attn"]["wq"][0, 3])
    assert len(tp["tail_local"].unstack()) == 1
    init = tparams.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in init.parameters()) == \
        jparams.param_count(jcfg)


@pytest.mark.parametrize("policy", [None, "int8"])
def test_ring_caches_match_jax(setup, policy):
    """Slot and paged decode caches: the same leaves, shapes, dtypes and
    empty values as the JAX package's; the rings stay slot-addressed in
    the paged cache, only ``global_k``/``global_v`` are pooled."""
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
            tl = list(tcache[key]) if isinstance(tcache[key], tuple) \
                else [tcache[key]]
            for a, t in zip(jax.tree.leaves(jleaf), tl):
                assert tuple(t.shape) == a.shape, key
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(a, np.float32))
        assert tkv.decode_cache_nbytes(tcache) == \
            jkv.decode_cache_nbytes(jcache)
    assert tkv.paged_cache_keys(tcfg) == ("global_k", "global_v")
    assert tkv.kv_pool_block_bytes(tcfg, 64, tpol, 8) == \
        jkv.kv_pool_block_bytes(jcfg, 64, jpol, 8)


# ---------------------------------------------------------------------------
# Serving gemma3: token-exact against the JAX engines
# ---------------------------------------------------------------------------
def _workload(vocab):
    """Prompts of 3 to 21 tokens with budgets up to 12: the window of 8
    wraps in the prompt and in the decode."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (3, 11, 7, 21)]
    return prompts, [5, 12, 6, 3]


def _run(engine, prompts, budgets):
    reqs = engine.submit(prompts, max_new_tokens=budgets)
    metrics = engine.run()
    return [r.tokens for r in reqs], metrics


_KW = dict(slots=2, max_prompt=24, max_new_tokens=12)


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("precision", ["float", "int8", "int8_fakequant"])
def test_continuous_ring_serving_matches_jax(setup, precision, chunk):
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_KW, prefill_chunk=chunk, precision=precision)
    want, jm = _run(JaxServer(jcfg, jp, **kw), prompts, budgets)
    got, tm = _run(ContinuousBatchServer(tcfg, tp, device="cpu", **kw),
                   prompts, budgets)
    assert got == want
    assert (tm["decode_steps"], tm["prefill_chunks"]) == \
        (jm["decode_steps"], jm["prefill_chunks"])


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_static_ring_serving_matches_jax(setup, precision):
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


# 3 slots of 4 blocks of 8 over a pool of 7: preemption, rings rebuilt
_PAGED_KW = dict(slots=3, max_prompt=24, prefill_chunk=4, max_new_tokens=12,
                 block_size=8, pool_blocks=7)


def test_paged_ring_serving_matches_jax(setup):
    """Float: a pool too small for the three slots preempts, and the
    re-prefill rebuilds the evicted slot's rings; tokens, preemptions and
    step counts equal the JAX paged engine's.  Prefix sharing is off for
    a ring trunk (shared prompts, no hit)."""
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


@pytest.mark.parametrize("precision", ["int8", "int8_fakequant"])
def test_paged_ring_int8_matches_jax_continuous(setup, precision):
    """int8 paged serving of gemma3 (whose JAX paged run crashes XLA's
    compiler): the JAX continuous engine's tokens, and the schedule
    (preemptions, step counts) of the port's own float paged run."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _workload(tcfg.vocab_size)
    kw = dict(_PAGED_KW, precision=precision)
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
    assert tm["preemptions"] > 0
