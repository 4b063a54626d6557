"""Port parity: one-shot prefill (``forward_prefill``, ``grow_cache``,
``make_prefill_step``) against the JAX package, on the CPU.

The five smoke configs whose trunks the port has, in float32 with the JAX
package's own weights carried across: internlm2-1.8b, granite-3-8b and
llama3.2-3b (uniform dense; G 2, 2 and 3), gemma3-4b (local:global, a
window of 8) and falcon-mamba-7b (mamba1).  The last-token logits and
every cache leaf must agree within ``ATOL`` (f32 sums in another order);
positions, ring placement and cache structure exactly.  falcon-mamba is
compared only at lengths the reference's chunked scan takes (a multiple
of its chunk count, ``ROADMAP.md`` queue 3).  Then the port's prefill
oracle, prefill, ``grow_cache`` and greedy decode, gives the tokens of
the JAX package's ``_reference_decode`` (``tests/test_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.serve_step import make_prefill_step

torch.set_num_threads(1)

ATOL = 1e-5
ARCHS = ("internlm2-1.8b", "granite-3-8b", "llama3.2-3b", "gemma3-4b",
         "falcon-mamba-7b")
_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
        jp = jinit(jcfg, jax.random.key(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _SETUPS[arch] = (jcfg, tcfg, jp, tp)
    return _SETUPS[arch]


def _tokens(vocab, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _leaves(leaf):
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def _assert_cache_close(jcache, tcache, atol=ATOL):
    assert list(tcache) == list(jcache)
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


# (arch, batch, prompt length): gemma3's window is 8, so 13 wraps the ring
# and 5 leaves it part empty; falcon-mamba's reference takes S 256 (two
# chunks of 128) and any S below 128
CASES = [("internlm2-1.8b", 2, 13), ("granite-3-8b", 2, 13),
         ("llama3.2-3b", 2, 13), ("gemma3-4b", 2, 13), ("gemma3-4b", 1, 5),
         ("falcon-mamba-7b", 2, 256)]


@pytest.mark.parametrize("arch,b,s", CASES)
def test_forward_prefill_matches_jax(arch, b, s):
    """Last-token logits and the whole cache, leaf for leaf."""
    jcfg, tcfg, jp, tp = _setup(arch)
    tok = _tokens(jcfg.vocab_size, b, s)
    jl, jcache = japi.model_fns(jcfg).forward_prefill(
        jcfg, jp, {"tokens": jnp.asarray(tok)})
    tl, tcache = tapi.model_fns(tcfg).forward_prefill(
        tcfg, tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(jcache, tcache)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
@pytest.mark.parametrize("precision", ["int8", "int8_fakequant"])
def test_forward_prefill_int8_cache_matches_jax(arch, precision):
    """Under an int8 policy the cache is quantized after it is built
    (after the ring gather): ``Int8KV`` leaves (values bitwise, scales
    within ``ATOL``) or their quantize-dequantize round trip."""
    jcfg, tcfg, jp, tp = _setup(arch)
    tok = _tokens(jcfg.vocab_size, 1, 11, seed=1)
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    jl, jcache = jtr.forward_prefill(jcfg, jq.quantize_model_params(
        jp, jpol), {"tokens": jnp.asarray(tok)}, policy=jpol)
    tl, tcache = ttr.forward_prefill(tcfg, tq.quantize_model_params(
        tp, tpol), {"tokens": torch.from_numpy(tok)}, policy=tpol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_cache_close(jcache, tcache, atol=1e-4)


def _jax_reference_decode(cfg, params, prompt, max_new):
    """``tests/test_serve.py::_reference_decode``: exact-length prefill,
    ``grow_cache``, contiguous decode."""
    fns = japi.model_fns(cfg)
    logits, cache = fns.forward_prefill(cfg, params,
                                        {"tokens": jnp.asarray(prompt[None])})
    cache = jtr.grow_cache(cfg, cache, max_new + 1)
    out = [int(jnp.argmax(logits, -1)[0])]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        logits, cache = fns.forward_decode(
            cfg, params, cache, jnp.asarray([out[-1]], jnp.int32),
            jnp.asarray([pos], jnp.int32))
        out.append(int(jnp.argmax(logits, -1)[0]))
    return out


def _port_reference_decode(cfg, params, prompt, max_new):
    """The same oracle in the port: ``make_prefill_step``, ``grow_cache``,
    greedy decode."""
    tok, _, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(prompt[None])})
    cache = ttr.grow_cache(cfg, cache, max_new + 1)
    out = [int(tok[0])]
    fns = tapi.model_fns(cfg)
    with torch.no_grad():
        for pos in range(len(prompt), len(prompt) + max_new - 1):
            logits, cache = fns.forward_decode(
                cfg, params, cache, torch.tensor([out[-1]], dtype=torch.int32),
                torch.tensor([pos], dtype=torch.int32))
            out.append(int(logits[0].argmax()))
    return out


@pytest.mark.parametrize("arch,s", [("internlm2-1.8b", 9), ("granite-3-8b", 9),
                                    ("llama3.2-3b", 9), ("gemma3-4b", 19),
                                    ("falcon-mamba-7b", 9)])
def test_prefill_grow_decode_matches_jax_reference(arch, s):
    """Prefill, ``grow_cache``, then 10 greedy tokens: the JAX oracle's
    tokens exactly (gemma3's ring wraps in the prompt and again in the
    decode)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    prompt = _tokens(jcfg.vocab_size, 1, s, seed=3)[0]
    want = _jax_reference_decode(jcfg, jp, prompt, 10)
    assert _port_reference_decode(tcfg, tp, prompt, 10) == want


def test_grow_cache_matches_jax():
    """Full-attention leaves grow by ``extra`` zero rows (positions −1),
    ``Int8KV`` scales with them; rings keep their size."""
    jcfg, tcfg, jp, tp = _setup("gemma3-4b")
    tok = _tokens(jcfg.vocab_size, 1, 6, seed=4)
    jpol, tpol = jq.policy_for("int8"), tq.policy_for("int8")
    _, jcache = jtr.forward_prefill(jcfg, jq.quantize_model_params(jp, jpol),
                                    {"tokens": jnp.asarray(tok)}, policy=jpol)
    _, tcache = ttr.forward_prefill(tcfg, tq.quantize_model_params(tp, tpol),
                                    {"tokens": torch.from_numpy(tok)},
                                    policy=tpol)
    _assert_cache_close(jtr.grow_cache(jcfg, jcache, 7),
                        ttr.grow_cache(tcfg, tcache, 7), atol=1e-4)


def test_prefill_step_and_refusals():
    """``make_prefill_step`` returns the greedy token of the logits it
    returns; ``positions`` and ``embeddings`` inputs run (the kernel masks
    by position; once refused, named for that refusal): the default
    positions brought by the caller give the logits of none, embeddings
    of the tokens the logits of the tokens, shifted positions stamp the
    cache; the mamba1 trunk both trains (``forward_train`` under autograd
    gives the reference's loss, and gradients reach its weights) and
    prefills (without autograd)."""
    jcfg, tcfg, jp, tp = _setup("internlm2-1.8b")
    tok = torch.from_numpy(_tokens(tcfg.vocab_size, 2, 5))
    nxt, logits, cache = make_prefill_step(tcfg)(tp, {"tokens": tok})
    assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))
    assert set(cache) == {"k", "v", "full_pos"}
    idx = ttr.default_positions(2, 5)
    emb = ttr.embed_tokens(tp, tok, tcfg)
    for extra in ({"positions": idx}, {"embeddings": emb}):
        got, _ = ttr.forward_prefill(tcfg, tp, {"tokens": tok, **extra})
        np.testing.assert_allclose(got.numpy(), logits.numpy(), atol=ATOL)
    shifted = (idx + 7).contiguous()
    got, scache = ttr.forward_prefill(tcfg, tp, {"tokens": tok,
                                                 "positions": shifted})
    want, jcache = jtr.forward_prefill(jcfg, jp, {
        "tokens": jnp.asarray(tok.numpy()),
        "positions": jnp.asarray(shifted.numpy())})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _assert_cache_close(jcache, scache)
    jmcfg, mcfg, jmp, mp = _setup("falcon-mamba-7b")
    mtok = torch.from_numpy(_tokens(mcfg.vocab_size, 1, 8))
    jloss, _ = jtr.forward_train(jmcfg, jmp, {
        "tokens": jnp.asarray(mtok.numpy()),
        "labels": jnp.asarray(mtok.numpy())})
    trainable = params_from_numpy(jax.tree.map(np.asarray, jmp),
                                  device="cpu", trainable=True)
    loss, _ = ttr.forward_train(mcfg, trainable, {"tokens": mtok,
                                                  "labels": mtok})
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    loss.backward()
    assert float(trainable["blocks"]["mamba"]["a_log"].grad.abs().max()) > 0
    _, mcache = ttr.forward_prefill(mcfg, mp, {"tokens": mtok})
    assert tuple(mcache["ssm"].h.shape) == (mcfg.n_layers, 1, mcfg.d_inner,
                                            mcfg.ssm_state)
