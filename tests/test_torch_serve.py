"""Port parity: the PyTorch ``ContinuousBatchServer`` and
``StaticBatchServer`` against the JAX ones, in float and int8.

On the CPU (``device="cpu"``), on the ``internlm2-1.8b`` smoke config
with a float32 override and the JAX package's own weights carried across.
Greedy serving must give **the same tokens** as the JAX engine on the
prompts and budgets of ``tests/test_serve.py::
test_chunked_prefill_matches_reference``, and as the port's own
single-request decode (one exact-length prefill chunk, then contiguous
decode).  The scheduler invariants of the JAX tests hold too.

Int8 serving is held token-exact against the JAX int8 engines and
against a *chunked* oracle: the prompt prefilled in the engine's chunks
of 4, then greedy decode, once under the fake-quant policy and once under
native int8.  The chunked engines write each chunk's K/V into the int8
cache and attend over the quantized entries; a one-shot prefill attends
over the prompt's unquantized K/V and is not an oracle of them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.params import init_params as jinit
from repro.serve.server import ContinuousBatchServer as JaxServer
from repro.serve.server import StaticBatchServer as JaxStatic
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.kvcache import alloc_decode_cache
from repro_torch.serve.server import (ContinuousBatchServer,
                                      PagedBatchServer, StaticBatchServer)

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _single_decode(cfg, params, prompt, max_new):
    """No-batching oracle of the port: the whole prompt as one chunk, then
    contiguous decode against an unbounded batch-1 cache."""
    n = len(prompt)
    cache = alloc_decode_cache(cfg, 1, n + max_new, "cpu")
    logits, cache = ttr.forward_prefill_chunk(
        cfg, params, cache, torch.from_numpy(prompt[None]),
        torch.arange(n, dtype=torch.int32)[None])
    out = [int(logits[0, -1].argmax())]
    for pos in range(n, n + max_new - 1):
        logits, cache = ttr.forward_decode(
            cfg, params, cache, torch.tensor([out[-1]], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32))
        out.append(int(logits[0].argmax()))
    return out


def test_serving_matches_jax_and_single_decode(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(2)
    lens = [3, 11, 7, 16]
    budgets = [5, 4, 6, 3]
    prompts = [rng.randint(0, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8)
    jsrv = JaxServer(jcfg, jp, **kw)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jsrv.run()
    tsrv = ContinuousBatchServer(tcfg, tp, device="cpu", **kw)
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    metrics = tsrv.run()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    for r, p, b in zip(treqs, prompts, budgets):
        assert r.tokens == _single_decode(tcfg, tp, p, b), r.rid
    assert metrics["tokens_generated"] == sum(budgets)
    assert metrics["decode_steps"] == jsrv.metrics["decode_steps"]
    assert metrics["prefill_chunks"] == jsrv.metrics["prefill_chunks"]
    assert 0 < metrics["kv_fill_frac"] <= 1.0


def _first_fresh_token(tokens):
    """The first token after the first that none before it equals."""
    for i in range(1, len(tokens)):
        if tokens[i] not in tokens[:i]:
            return tokens[i]
    raise AssertionError(f"no fresh token in {tokens}")


@pytest.mark.parametrize("option", ["eos", "budget_and_cap"])
def test_serving_options_match_jax(setup, option):
    """The server's knobs, each against the JAX engine: a stop at
    ``eos_id``, and a prefill budget of two chunks per decode step with
    ``max_new_cap`` clipping the requests' budgets."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7, 16)]
    budgets = [5, 4, 6, 3]
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8)
    if option == "eos":
        eos = _first_fresh_token(_single_decode(tcfg, tp, prompts[0],
                                                budgets[0]))
        kw["eos_id"] = eos
    else:
        eos = None
        kw.update(prefill_token_budget=8, max_new_cap=4)
    jsrv = JaxServer(jcfg, jp, **kw)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jsrv.run()
    tsrv = ContinuousBatchServer(tcfg, tp, device="cpu", **kw)
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    metrics = tsrv.run()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert metrics["decode_steps"] == jsrv.metrics["decode_steps"]
    assert metrics["prefill_chunks"] == jsrv.metrics["prefill_chunks"]
    for r, p, b in zip(treqs, prompts, budgets):
        want = _single_decode(tcfg, tp, p, min(b, kw.get("max_new_cap", b)))
        if eos in want:
            want = want[:want.index(eos) + 1]
        assert r.tokens == want, r.rid
    if option == "eos":
        assert treqs[0].tokens[-1] == eos
        assert len(treqs[0].tokens) < budgets[0]
    else:
        assert [len(r.tokens) for r in treqs] == [4, 4, 4, 3]


def test_slot_recycling_admits_before_drain(setup):
    """A queued request is admitted into a freed slot while another is
    still decoding: the continuous-batching invariant."""
    _, tcfg, _, tp = setup
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab_size, 6).astype(np.int32)
               for _ in range(3)]
    srv = ContinuousBatchServer(tcfg, tp, slots=2, max_prompt=8,
                                prefill_chunk=8, max_new_tokens=12,
                                device="cpu")
    r1, r2, r3 = srv.submit(prompts, max_new_tokens=[2, 12, 6])
    srv.run()
    assert r1.finished_step is not None and r2.finished_step is not None
    assert r3.admitted_step is not None
    assert r3.admitted_step < r2.finished_step
    assert len(r3.tokens) == 6


def test_unported_options_raise(setup):
    """What the port refuses raises; ``use_artifact`` no longer does: it
    serves the eager engine's tokens (test_torch_eon_serve.py holds it
    against the JAX engines)."""
    _, tcfg, _, tp = setup
    prompts = [np.arange(3, 9, dtype=np.int32), np.arange(2, dtype=np.int32)]
    out = []
    for use_artifact in (False, True):
        srv = ContinuousBatchServer(tcfg, tp, slots=2, max_prompt=8,
                                    prefill_chunk=4, max_new_tokens=3,
                                    use_artifact=use_artifact, device="cpu")
        reqs = srv.submit(prompts)
        out.append(([r.tokens for r in reqs], srv.run()))
    assert out[1][0] == out[0][0]
    assert out[1][1]["artifact_bytes"] > 0
    assert "artifact_bytes" not in out[0][1]
    # calibrated activations are served (test_torch_calibrated.py)
    srv = ContinuousBatchServer(
        tcfg, tp, device="cpu",
        precision=tq.PrecisionPolicy(weights="int8",
                                     activations="calibrated"))
    assert srv.prec.activations == "calibrated"
    with pytest.raises(ValueError, match="unknown precision"):
        ContinuousBatchServer(tcfg, tp, precision="int4", device="cpu")


def _chunked_oracle(cfg, params, prompt, max_new, policy, chunk=4):
    """Single-request greedy decode through the engines' own admission
    path: the prompt in chunks of ``chunk`` (ragged tail at position −1)
    into a batch-1 cache, then contiguous decode, under ``policy``."""
    qparams = tq.quantize_model_params(params, policy)
    n = len(prompt)
    cap = -(-n // chunk) * chunk + max_new
    cache = alloc_decode_cache(cfg, 1, cap, "cpu", policy)
    for p in range(0, n, chunk):
        r = min(chunk, n - p)
        toks = np.zeros((1, chunk), np.int32)
        poss = np.full((1, chunk), -1, np.int32)
        toks[0, :r] = prompt[p:p + r]
        poss[0, :r] = np.arange(p, p + r)
        logits, cache = ttr.forward_prefill_chunk(
            cfg, qparams, cache, torch.from_numpy(toks),
            torch.from_numpy(poss), policy=policy,
            kv_len=torch.tensor([p + chunk], dtype=torch.int32))
    out = [int(logits[0, r - 1].argmax())]
    for pos in range(n, n + max_new - 1):
        logits, cache = ttr.forward_decode(
            cfg, qparams, cache, torch.tensor([out[-1]], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), policy=policy,
            kv_len=torch.tensor([pos + 1], dtype=torch.int32))
        out.append(int(logits[0].argmax()))
    return out


def _int8_workload(vocab):
    """The prompts and budgets of ``tests/test_precision.py::
    test_int8_serving_token_exact``."""
    rng = np.random.RandomState(4)
    return ([rng.randint(0, vocab, n).astype(np.int32) for n in (3, 11, 7)],
            [5, 4, 6])


@pytest.mark.parametrize("precision", ["int8", "int8_fakequant"])
def test_int8_serving_matches_jax_and_chunked_oracle(setup, precision):
    """The int8 continuous engine gives the JAX int8 engine's tokens, and
    both give the chunked oracle's, under fake-quant and native int8."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _int8_workload(tcfg.vocab_size)
    kw = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8,
              precision=precision)
    jsrv = JaxServer(jcfg, jp, **kw)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jsrv.run()
    tsrv = ContinuousBatchServer(tcfg, tp, device="cpu", **kw)
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    metrics = tsrv.run()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert metrics["precision"] == precision
    assert metrics["decode_steps"] == jsrv.metrics["decode_steps"]
    assert metrics["kv_cache_bytes"] == jsrv.metrics["kv_cache_bytes"]
    for policy in (tq.INT8_FAKEQUANT, tq.INT8):
        want = [_chunked_oracle(tcfg, tp, p, b, policy)
                for p, b in zip(prompts, budgets)]
        assert [r.tokens for r in treqs] == want, policy


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_static_serving_matches_jax(setup, precision):
    """The static baseline against the JAX one, and (int8) against the
    chunked oracle and the port's continuous and paged engines: scheduling
    never changes tokens."""
    jcfg, tcfg, jp, tp = setup
    prompts, budgets = _int8_workload(tcfg.vocab_size)
    kw = dict(batch_size=2, max_prompt=16, prefill_chunk=4,
              max_new_tokens=8, precision=precision)
    jsrv = JaxStatic(jcfg, jp, **kw)
    jreqs = jsrv.submit(prompts, max_new_tokens=budgets)
    jsrv.run()
    tsrv = StaticBatchServer(tcfg, tp, device="cpu", **kw)
    treqs = tsrv.submit(prompts, max_new_tokens=budgets)
    metrics = tsrv.run()
    tokens = [r.tokens for r in treqs]
    assert tokens == [r.tokens for r in jreqs]
    assert metrics["engine"] == "static"
    for key in ("decode_steps", "prefill_chunks", "kv_cache_bytes",
                "tokens_generated"):
        assert metrics[key] == jsrv.metrics[key], key
    policy = tq.policy_for(precision)
    assert tokens == [_chunked_oracle(tcfg, tp, p, b, policy)
                      for p, b in zip(prompts, budgets)]
    for engine in (ContinuousBatchServer, PagedBatchServer):
        srv = engine(tcfg, tp, slots=2, max_prompt=16, prefill_chunk=4,
                     max_new_tokens=8, precision=precision, device="cpu")
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        assert [r.tokens for r in reqs] == tokens, engine.__name__


def test_over_capacity_prompt_errors(setup):
    _, tcfg, _, tp = setup
    srv = ContinuousBatchServer(tcfg, tp, slots=1, max_prompt=16,
                                max_new_tokens=8, device="cpu")
    rng = np.random.RandomState(0)
    ok = rng.randint(0, tcfg.vocab_size, 5).astype(np.int32)
    bad = rng.randint(0, tcfg.vocab_size, 200).astype(np.int32)
    with pytest.raises(ValueError, match="cache rows"):
        srv.submit([bad])
    with pytest.raises(ValueError, match="empty"):
        srv.submit([np.zeros((0,), np.int32)])
    with pytest.raises(ValueError):
        srv.submit([ok, bad])
    assert srv.requests == {} and not srv.sched.waiting
