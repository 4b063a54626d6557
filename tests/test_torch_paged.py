"""Port parity: the paged KV pool and ``PagedBatchServer`` against the JAX
package.

On the CPU.  ``BlockManager`` must give the same block ids, refcounts
and hashes as JAX's for the same calls, and the paged cache the same
layout and byte counts.  Paged serving, float and int8, must give the JAX
engine's tokens, preemptions and prefix hits on the smoke config in
float32, with a pool small enough to preempt and prompts that share a
prefix.  The attention through the block table is held against JAX in
``tests/test_torch_paged_attention.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quantize import INT8 as JINT8
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.server import PagedBatchServer as JaxPaged
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import PagedBatchServer

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# Pool bookkeeping
# ---------------------------------------------------------------------------
def test_block_manager_matches_jax():
    """The same alloc/free/match/register calls give the same block ids,
    refcounts, stats and hashes as the JAX package's allocator, through
    prefix hits, LRU reclaim under pressure and pool exhaustion."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 500, 40).astype(np.int32)
    other = rng.randint(0, 500, 24).astype(np.int32)
    managers = [jkv.BlockManager(8, 8), tkv.BlockManager(8, 8)]
    trace = []
    for m in managers:
        out = []
        a = m.alloc(5)
        m.register_prefix(toks, a)
        out.append(("alloc", a, m.block_hashes(toks)))
        hit = m.match_prefix(toks)
        out.append(("match", hit, m.match_prefix(other)))
        m.unmatch(hit[2:])
        m.free(a)
        b = m.alloc(3)
        out.append(("reclaim", b, m.free_blocks, m.registry_size()))
        try:
            m.alloc(9)
        except RuntimeError as e:
            out.append(("exhausted", type(e).__name__))
        m.free(b)
        m.free(hit[:2])
        out.append(("state", m.refcount.tolist(), dict(m.stats),
                    m.free_blocks, m.live_blocks, m.can_alloc(8)))
        trace.append(out)
    assert trace[0] == trace[1]
    assert trace[1][3] == ("exhausted", "PoolExhausted")


@pytest.mark.parametrize("policy", [None, "int8"])
def test_paged_cache_layout_matches_jax(setup, policy):
    jcfg, tcfg, _, _ = setup
    jpol = None if policy is None else JINT8
    tpol = None if policy is None else tq.INT8
    jcache = jkv.alloc_paged_cache(jcfg, 2, 64, 5, jpol, block_size=8)
    tcache = tkv.alloc_paged_cache(tcfg, 2, 64, 5, "cpu", tpol,
                                   block_size=8)
    assert set(tcache) == set(jcache) == {"k", "v", "pool_pos"}
    for key in ("k", "v"):
        jl, tl = jcache[key], tcache[key]
        for jt, tt in (zip(jl, tl) if policy else [(jl, tl)]):
            assert tuple(tt.shape) == jt.shape
            assert tt.dtype == getattr(torch, str(jt.dtype))
            assert not tt.any()
    assert torch.equal(tcache["pool_pos"],
                       torch.full((5, 8), -1, dtype=torch.int32))
    assert tkv.decode_cache_nbytes(tcache) == jkv.decode_cache_nbytes(jcache)
    assert tkv.kv_pool_block_bytes(tcfg, 64, tpol, 8) == \
        jkv.kv_pool_block_bytes(jcfg, 64, jpol, 8)
    meta = tkv.abstract_paged_cache(tcfg, 2, 64, 5, tpol, 8)
    assert meta["pool_pos"].device.type == "meta"
    assert tkv.decode_cache_nbytes(meta) == tkv.decode_cache_nbytes(tcache)
    for prec in ("float", "int8"):
        assert tkv.kv_cache_bytes(tcfg, 4, 576, precision=prec) == \
            jkv.kv_cache_bytes(jcfg, 4, 576, precision=prec)


# ---------------------------------------------------------------------------
# Paged serving: token-exact against the JAX engine
# ---------------------------------------------------------------------------
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


class _SyncedJaxPaged(JaxPaged):
    """The JAX paged engine with each chunk step waited for.  On the CPU,
    ``jnp.asarray`` does not copy a 64-byte-aligned numpy array: the
    engine's block-table row reaches the asynchronously dispatched chunk
    step as a view of host memory that the scheduler goes on to rewrite
    (admission, growth, preemption).  Under CPU load the step can then
    read the new row and write the chunk's K/V into the wrong blocks.
    Waiting for each chunk step keeps the engine's own semantics and
    removes the race."""

    def _chunk_call(self, slot, toks, poss, kvl):
        return jax.block_until_ready(
            super()._chunk_call(slot, toks, poss, kvl))


def _serve_both(setup, prompts, budgets, **kw):
    jcfg, tcfg, jp, tp = setup
    jsrv = _SyncedJaxPaged(jcfg, jp, **kw)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jm = jsrv.run()
    tsrv = PagedBatchServer(tcfg, tp, device="cpu", **kw)
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    tm = tsrv.run()
    return jreqs, jm, treqs, tm, tsrv


@pytest.mark.parametrize("precision", ["float", "int8", "int8_fakequant"])
def test_paged_serving_matches_jax(setup, precision):
    """A pool of 8 blocks for 3 slots of 3 blocks forces preemption, and
    the shared prefix gives prefix-cache hits: tokens, preemptions,
    prefix hits and the step counts all equal the JAX engine's."""
    prompts, budgets = _prefix_workload(setup[1].vocab_size)
    jreqs, jm, treqs, tm, tsrv = _serve_both(
        setup, prompts, budgets, precision=precision, **_PAGED_KW)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert tm["preemptions"] >= 1 and tm["prefix_hit_blocks"] >= 1
    for key in ("preemptions", "prefix_hit_blocks", "prefix_hit_rate",
                "decode_steps", "prefill_chunks", "pool_live_blocks_peak",
                "pool_live_blocks_mean", "kv_cache_bytes", "kv_block_bytes",
                "kv_live_bytes_peak", "tokens_generated"):
        assert tm[key] == jm[key], key
    assert [len(r.tokens) for r in treqs] == budgets
    assert tsrv.manager.free_blocks + tsrv.manager.registry_size() == \
        tsrv.pool_blocks


@pytest.mark.parametrize("option", ["no_prefix_cache", "eos",
                                    "budget_and_cap", "default_pool"])
def test_paged_options_match_jax(setup, option):
    """The paged engine's other knobs against the JAX engine: prefix
    caching off, a stop at ``eos_id``, two chunks per decode step with
    ``max_new_cap`` clipping the budgets, and the default pool (the
    contiguous rectangle's block count, no preemption)."""
    prompts, budgets = _prefix_workload(setup[1].vocab_size)
    kw = dict(_PAGED_KW, precision="int8")
    if option == "no_prefix_cache":
        kw["prefix_cache"] = False
    elif option == "eos":
        first = _serve_both(setup, prompts[:1], budgets[:1], **kw)[2][0]
        kw["eos_id"] = first.tokens[2]
    elif option == "budget_and_cap":
        kw.update(prefill_token_budget=8, max_new_cap=6)
    else:
        del kw["pool_blocks"], kw["block_size"]
    jreqs, jm, treqs, tm, _ = _serve_both(setup, prompts, budgets, **kw)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    for key in ("preemptions", "prefix_hit_blocks", "decode_steps",
                "prefill_chunks", "pool_blocks", "block_size"):
        assert tm[key] == jm[key], key
    if option == "no_prefix_cache":
        assert tm["prefix_hit_blocks"] == 0 and tm["preemptions"] >= 1
    elif option == "eos":
        assert treqs[0].tokens[-1] == kw["eos_id"]
        assert len(treqs[0].tokens) < budgets[0]
    elif option == "budget_and_cap":
        assert max(len(r.tokens) for r in treqs) == 6
    else:
        assert tm["preemptions"] == 0


def test_paged_rejects_what_jax_rejects(setup):
    _, tcfg, _, tp = setup
    with pytest.raises(ValueError, match="block_size"):
        PagedBatchServer(tcfg, tp, max_prompt=20, block_size=12,
                         device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedBatchServer(tcfg, tp, max_prompt=20, prefill_chunk=24,
                         device="cpu")
    # the decode artifact is served, not refused (test_torch_eon_serve.py)
    art = PagedBatchServer(tcfg, tp, slots=2, max_prompt=20, prefill_chunk=4,
                           max_new_tokens=4, block_size=8, use_artifact=True,
                           device="cpu")
    assert art.artifact.memory["kv_pool_blocks"] == art.pool_blocks
    srv = PagedBatchServer(tcfg, tp, slots=2, max_prompt=20, prefill_chunk=4,
                           max_new_tokens=4, block_size=8, pool_blocks=2,
                           device="cpu")
    srv.submit([np.arange(18, dtype=np.int32)])
    with pytest.raises(tkv.PoolExhausted):
        srv.run()
