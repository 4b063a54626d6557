"""Port parity: the engines served from the decode artifact
(``use_artifact=True``) against the eager engines and the JAX engines
served from theirs, on the CPU.

On the ``internlm2-1.8b`` smoke config with a float32 override and the
JAX package's weights carried across, ``ContinuousBatchServer`` and
``PagedBatchServer`` with ``use_artifact=True`` give the same tokens as
the port's eager engines and as the JAX engines with ``use_artifact=True``
(the paged one with each chunk step waited for, as in
``test_torch_paged.py``), in float and int8; the paged workload preempts
and hits the prefix cache, so the block table changes under the artifact
between steps.  ``run()``'s metrics carry ``artifact_bytes``.  The
falcon-mamba smoke config serves from its artifact on both engines with
the eager engines' tokens and the JAX eager engine's (the JAX package
cannot serialize its mamba artifact: ROADMAP.md queue 3).  Last, the
launcher's ``--artifact``.
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
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import PagedBatchServer as JaxPaged
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.server import ContinuousBatchServer, PagedBatchServer

torch.set_num_threads(1)


class _SyncedJaxPaged(JaxPaged):
    """The JAX paged engine with each chunk step waited for (its block-
    table row reaches the asynchronous step as a view of host memory the
    scheduler goes on to rewrite; ``test_torch_paged.py``)."""

    def _chunk_call(self, slot, toks, poss, kvl):
        return jax.block_until_ready(
            super()._chunk_call(slot, toks, poss, kvl))


def _setup(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def dense():
    return _setup("internlm2-1.8b")


def _serve(engine, cfg, params, prompts, budgets, **kw):
    srv = engine(cfg, params, **kw)
    reqs = srv.submit(prompts, max_new_tokens=budgets)
    metrics = srv.run()
    return [r.tokens for r in reqs], metrics, srv


def _continuous_workload(vocab):
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (3, 11, 7, 16)]
    return prompts, [5, 4, 6, 3]


def _paged_workload(vocab):
    """Three prompts near the slot capacity, then three that share a
    16-token prefix: a pool of 8 blocks for 3 slots of 3 preempts."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (14, 15, 13)]
    base = rng.randint(0, vocab, 16).astype(np.int32)
    prompts += [np.concatenate([base, rng.randint(0, vocab, n)
                                .astype(np.int32)]) for n in (1, 3, 2)]
    return prompts, [6, 5, 7, 4, 6, 5]


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_continuous_artifact_matches_eager_and_jax(dense, precision):
    jcfg, tcfg, jp, tp = dense
    prompts, budgets = _continuous_workload(tcfg.vocab_size)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8,
              precision=precision)
    jtok, jm, jsrv = _serve(JaxServer, jcfg, jp, prompts, budgets,
                            use_artifact=True, **kw)
    etok, em, _ = _serve(ContinuousBatchServer, tcfg, tp, prompts, budgets,
                         device="cpu", **kw)
    atok, am, asrv = _serve(ContinuousBatchServer, tcfg, tp, prompts,
                            budgets, device="cpu", use_artifact=True, **kw)
    assert atok == etok == jtok
    assert am["artifact_bytes"] == asrv.artifact.artifact_bytes > 0
    assert asrv.artifact.name == jsrv.artifact.name
    for key in ("decode_steps", "prefill_chunks", "tokens_generated",
                "kv_cache_bytes"):
        assert am[key] == em[key] == jm[key], key


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_paged_artifact_matches_eager_and_jax(dense, precision):
    jcfg, tcfg, jp, tp = dense
    prompts, budgets = _paged_workload(tcfg.vocab_size)
    kw = dict(slots=3, max_prompt=20, prefill_chunk=4, max_new_tokens=12,
              block_size=8, pool_blocks=8, precision=precision)
    jtok, jm, jsrv = _serve(_SyncedJaxPaged, jcfg, jp, prompts, budgets,
                            use_artifact=True, **kw)
    etok, em, _ = _serve(PagedBatchServer, tcfg, tp, prompts, budgets,
                         device="cpu", **kw)
    atok, am, asrv = _serve(PagedBatchServer, tcfg, tp, prompts, budgets,
                            device="cpu", use_artifact=True, **kw)
    assert atok == etok == jtok
    assert am["preemptions"] >= 1 and am["prefix_hit_blocks"] >= 1
    assert am["artifact_bytes"] > 0
    for key in ("preemptions", "prefix_hit_blocks", "decode_steps",
                "prefill_chunks", "kv_block_bytes"):
        assert am[key] == em[key] == jm[key], key
    for key in ("kv_pool_blocks", "kv_block_bytes", "kv_cache_bytes",
                "kv_cache_bytes_float", "param_bytes"):
        assert asrv.artifact.memory[key] == jsrv.artifact.memory[key], key


@pytest.mark.parametrize("engine", [ContinuousBatchServer, PagedBatchServer],
                         ids=["continuous", "paged"])
def test_mamba_artifact_matches_eager_and_jax(engine):
    jcfg, tcfg, jp, tp = _setup("falcon-mamba-7b")
    prompts, budgets = _continuous_workload(tcfg.vocab_size)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8)
    jtok, _, _ = _serve(JaxServer, jcfg, jp, prompts, budgets, **kw)
    etok, _, _ = _serve(engine, tcfg, tp, prompts, budgets, device="cpu",
                        **kw)
    atok, am, _ = _serve(engine, tcfg, tp, prompts, budgets, device="cpu",
                         use_artifact=True, **kw)
    assert atok == etok == jtok
    assert am["artifact_bytes"] > 0


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_launcher_artifact_flag(monkeypatch, capsys, engine):
    """``--artifact`` serves the same schedule as the eager launcher and
    reports the artifact's bytes."""
    out = []
    for flag in ([], ["--artifact"]):
        monkeypatch.setattr(sys, "argv", [
            "serve", "--device", "cpu", "--engine", engine, "--requests",
            "3", "--slots", "2", "--prompt-len", "8", "--max-new", "4",
            "--precision", "int8", *flag])
        tlaunch.main()
        out.append(json.loads(capsys.readouterr().out))
    eager, art = out
    assert art["artifact_bytes"] > 0 and "artifact_bytes" not in eager
    for key in ("tokens_generated", "decode_steps", "prefill_chunks"):
        assert art[key] == eager[key], key
