"""Port parity: serving ``falcon-mamba-7b`` (the uniform mamba1 trunk)
through the port's three engines against the JAX ones.

On the CPU (``device="cpu"``), on the smoke config with a float32
override and the JAX package's own weights carried across, with the
prompts and budgets of ``tests/test_chunked_prefill.py``'s serving tests.
Greedy serving must give **the same tokens** as the JAX engine:
continuous batching at chunks 1, 4 and 16, static batching, and the paged
engine, which for a pure SSM trunk pages nothing and falls back to
continuous batching with the pool bookkeeping off (no blocks, no prefix
sharing, no preemption), float and int8.  Nothing of the SSM family is
quantized, so int8 serves float's tokens.  The state's bytes equal the
JAX package's.
"""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import PagedBatchServer as JaxPaged
from repro.serve.server import StaticBatchServer as JaxStatic
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
_LENS, _BUDGETS = (5, 12, 9, 3, 16), (6, 4, 8, 5, 3)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _workload(vocab, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in _LENS]


class _SyncedJaxPaged(JaxPaged):
    """The JAX paged engine with each chunk step waited for (its block-table
    row reaches the asynchronously dispatched step as a view of host memory
    the scheduler rewrites; see ``tests/test_torch_paged.py``)."""

    def _chunk_call(self, slot, toks, poss, kvl):
        return jax.block_until_ready(
            super()._chunk_call(slot, toks, poss, kvl))


def _serve(engine, cfg, params, prompts, **kw):
    srv = engine(cfg, params, **kw)
    reqs = srv.submit(prompts, max_new_tokens=list(_BUDGETS))
    metrics = srv.run()
    return [r.tokens for r in reqs], metrics, srv


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_continuous_serving_matches_jax(setup, chunk):
    jcfg, tcfg, jp, tp = setup
    prompts = _workload(tcfg.vocab_size)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=chunk, max_new_tokens=8)
    jt, jm, _ = _serve(JaxServer, jcfg, jp, prompts, **kw)
    tt, tm, _ = _serve(ContinuousBatchServer, tcfg, tp, prompts,
                       device="cpu", **kw)
    assert tt == jt
    assert [len(t) for t in tt] == list(_BUDGETS)
    for key in ("decode_steps", "prefill_chunks", "tokens_generated",
                "kv_cache_bytes"):
        assert tm[key] == jm[key], key


def test_static_serving_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    prompts = _workload(tcfg.vocab_size, seed=4)
    kw = dict(batch_size=2, max_prompt=16, prefill_chunk=4,
              max_new_tokens=8)
    jt, jm, _ = _serve(JaxStatic, jcfg, jp, prompts, **kw)
    tt, tm, _ = _serve(StaticBatchServer, tcfg, tp, prompts, device="cpu",
                       **kw)
    assert tt == jt
    for key in ("decode_steps", "prefill_chunks", "kv_cache_bytes"):
        assert tm[key] == jm[key], key


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_paged_serving_matches_jax(setup, precision):
    """Blocks of 8 and a pool of 4 blocks, below what the prompts would
    need if anything were paged: the SSM engine allocates no block, shares
    no prefix and preempts nothing, as the JAX engine, and serves the same
    tokens."""
    jcfg, tcfg, jp, tp = setup
    prompts = _workload(tcfg.vocab_size, seed=6)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8,
              block_size=8, pool_blocks=4, precision=precision)
    jt, jm, _ = _serve(_SyncedJaxPaged, jcfg, jp, prompts, **kw)
    tt, tm, tsrv = _serve(PagedBatchServer, tcfg, tp, prompts, device="cpu",
                          **kw)
    assert tt == jt
    for key in ("preemptions", "prefix_hit_blocks", "decode_steps",
                "prefill_chunks", "kv_cache_bytes", "kv_block_bytes",
                "pool_live_blocks_peak", "tokens_generated"):
        assert tm[key] == jm[key], key
    assert tm["preemptions"] == 0 and tm["pool_live_blocks_peak"] == 0
    assert tsrv.manager.free_blocks == tsrv.pool_blocks


def test_int8_serves_float_tokens(setup):
    """No leaf of the SSM family is quantized: int8 gives float's tokens
    on the continuous engine, and the JAX int8 engine's."""
    jcfg, tcfg, jp, tp = setup
    prompts = _workload(tcfg.vocab_size, seed=5)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8)
    jt, _, _ = _serve(JaxServer, jcfg, jp, prompts, precision="int8", **kw)
    tokens = {prec: _serve(ContinuousBatchServer, tcfg, tp, prompts,
                           device="cpu", precision=prec, **kw)[0]
              for prec in ("float", "int8")}
    assert tokens["int8"] == tokens["float"] == jt


@pytest.mark.parametrize("slots,dtype", [(3, "float32"), (4, "bfloat16")])
def test_state_bytes_match_jax(slots, dtype):
    """``kv_cache_bytes`` prices the allocated state: conv in the
    activation dtype, h in f32, as the JAX package's cache and formula."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
    cache = tkv.alloc_decode_cache(tcfg, slots, 32, "cpu")
    width = torch.tensor([], dtype=tcfg.activation_dtype).element_size()
    assert tkv.decode_cache_nbytes(cache) == \
        jkv.decode_cache_nbytes(jkv.alloc_decode_cache(jcfg, slots, 32)) \
        == tkv.kv_cache_bytes(tcfg, slots, 32, width) \
        == jkv.kv_cache_bytes(jcfg, slots, 32, width)
    full = tconfigs.get(ARCH)
    assert tkv.kv_cache_bytes(full, 4, 576) == \
        jkv.kv_cache_bytes(jconfigs.get(ARCH), 4, 576) == 146_800_640


def test_launcher_serves_falcon_mamba_on_the_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    falcon-mamba-7b``: the smoke config in bf16 through the paged engine
    at int8."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", ARCH, "--engine", "paged",
        "--precision", "int8", "--requests", "3", "--slots", "2",
        "--prompt-len", "12", "--max-new", "4"])
    tlaunch.main()
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["tokens_generated"] == 12 and metrics["preemptions"] == 0
