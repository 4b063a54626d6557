"""Port parity: the mamba1 layer and the uniform SSM trunk
(``repro_torch.models.ssm``, ``models/transformer.py``) against the JAX
package's, on the ``falcon-mamba-7b`` smoke config with a float32
override and the JAX package's own weights carried across.

On the CPU, where the port's scan is the plain loop of
``kernels/ref.py`` and the JAX layer scans with ``lax.associative_scan``:
both compute in float32 in another order, so layer outputs and states
agree within 2e-5 and the trunk's logits within 2e-4 (the limit of
``tests/test_chunked_prefill.py``'s chunked-against-one-shot test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve import kvcache as tkv

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
LAYER_ATOL = 2e-5
LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _layer0(jp, tp):
    jl = jax.tree.map(lambda x: x[0], jp["blocks"])["mamba"]
    return jl, tp["blocks"].unstack()[0]["mamba"]


def _close(got, want, atol=LAYER_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _state(rng, cfg, b):
    conv = rng.randn(b, cfg.d_conv - 1, cfg.d_inner).astype(np.float32)
    h = rng.randn(b, cfg.d_inner, cfg.ssm_state).astype(np.float32) * 0.5
    return (jssm.SSMState(jnp.asarray(conv), jnp.asarray(h)),
            tssm.SSMState(torch.from_numpy(conv), torch.from_numpy(h)))


@pytest.mark.parametrize("case", ["fresh", "carried", "ragged"])
def test_mamba1_layer_matches_jax(setup, case):
    """Outputs and final (conv, h) of one layer over a chunk: from zeros,
    from a carried state, and with a ragged mask/fill (rows of 9 and 5 real
    steps of 9), against the JAX layer."""
    jcfg, tcfg, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, tcfg.d_model).astype(np.float32) * 0.5
    jst, tst = _state(rng, tcfg, 2) if case != "fresh" else (None, None)
    kw_j, kw_t = {}, {}
    if case == "ragged":
        fill = np.array([9, 5], np.int32)
        mask = np.arange(9)[None, :] < fill[:, None]
        kw_j = dict(mask=jnp.asarray(mask), fill=jnp.asarray(fill))
        kw_t = dict(mask=torch.from_numpy(mask), fill=torch.from_numpy(fill))
    yj, sj = jssm.mamba1_layer(jl, jnp.asarray(x), jcfg, jst, **kw_j)
    yt, st = tssm.mamba1_layer(tl, torch.from_numpy(x), tcfg, tst, **kw_t)
    if case == "ragged":
        yj, yt = np.asarray(yj)[1, :5], yt[1, :5]     # the real rows
    _close(yt, yj)
    _close(st.conv, sj.conv)
    _close(st.h, sj.h)


def test_masked_tail_state_equals_truncated_prefix(setup):
    """``tests/test_chunked_prefill.py::test_mamba_mask_fill_exact_state``
    on the port: a masked tail leaves (conv, h) exactly where the real
    prefix put them."""
    _, tcfg, jp, tp = setup
    _, tl = _layer0(jp, tp)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(1, 8, tcfg.d_model).astype(
            np.float32) * 0.1)
    mask = torch.arange(8)[None, :] < 5
    _, masked = tssm.mamba1_layer(tl, x, tcfg, mask=mask,
                                  fill=torch.tensor([5], dtype=torch.int32))
    _, cut = tssm.mamba1_layer(tl, x[:, :5], tcfg)
    assert torch.equal(masked.conv, cut.conv)
    assert torch.equal(masked.h, cut.h)


def test_mamba1_decode_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, tcfg.d_model).astype(np.float32) * 0.5
    jst, tst = _state(rng, tcfg, 3)
    yj, sj = jssm.mamba1_decode(jl, jnp.asarray(x), jcfg, jst)
    yt, st = tssm.mamba1_decode(tl, torch.from_numpy(x), tcfg, tst)
    _close(yt, yj)
    _close(st.conv, sj.conv)
    _close(st.h, sj.h)


def _jax_chunks(jcfg, jp, prompt, chunk, slots=1):
    cache = jkv.alloc_decode_cache(jcfg, slots, 24)
    fns = japi.model_fns(jcfg)
    p, last = 0, []
    while p < len(prompt):
        r = min(chunk, len(prompt) - p)
        toks = np.zeros((1, chunk), np.int32)
        poss = np.full((1, chunk), -1, np.int32)
        toks[0, :r] = prompt[p:p + r]
        poss[0, :r] = np.arange(p, p + r)
        logits, cache = fns.forward_prefill_chunk(
            jcfg, jp, cache, jnp.asarray(toks), jnp.asarray(poss),
            kv_len=jnp.asarray([p + chunk], jnp.int32))
        last.append(np.asarray(logits)[0, :r])
        p += r
    return np.concatenate(last), cache


def _torch_chunks(tcfg, tp, prompt, chunk):
    cache = tkv.alloc_decode_cache(tcfg, 1, 24, "cpu")
    p, last = 0, []
    while p < len(prompt):
        r = min(chunk, len(prompt) - p)
        toks = torch.zeros((1, chunk), dtype=torch.int32)
        poss = torch.full((1, chunk), -1, dtype=torch.int32)
        toks[0, :r] = torch.from_numpy(prompt[p:p + r])
        poss[0, :r] = torch.arange(p, p + r)
        logits, cache = ttr.forward_prefill_chunk(
            tcfg, tp, cache, toks, poss,
            kv_len=torch.tensor([p + chunk], dtype=torch.int32))
        last.append(logits[0, :r].numpy())
        p += r
    return np.concatenate(last), cache


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunks_then_decode_logits_match_jax(setup, chunk):
    """11 prompt tokens in chunks of 4 (a ragged tail) or one ragged chunk
    of 16, then three decode steps: every real row's logits and the final
    state against the JAX trunk."""
    jcfg, tcfg, jp, tp = setup
    prompt = np.random.RandomState(0).randint(
        0, tcfg.vocab_size, 11).astype(np.int32)
    lj, jcache = _jax_chunks(jcfg, jp, prompt, chunk)
    lt, tcache = _torch_chunks(tcfg, tp, prompt, chunk)
    _close(lt, lj, LOGIT_ATOL)
    tok = int(lt[-1].argmax())
    assert tok == int(lj[-1].argmax())
    fns = japi.model_fns(jcfg)
    for pos in range(11, 14):
        lj, jcache = fns.forward_decode(
            jcfg, jp, jcache, jnp.asarray([tok], jnp.int32),
            jnp.asarray([pos], jnp.int32))
        lt, tcache = ttr.forward_decode(
            tcfg, tp, tcache, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32))
        _close(lt, lj, LOGIT_ATOL)
        tok = int(lt[0].argmax())
        assert tok == int(np.asarray(lj)[0].argmax())
    _close(tcache["ssm"].conv, jcache["ssm"].conv)
    _close(tcache["ssm"].h, jcache["ssm"].h)


def test_idle_slot_state_is_bit_identical_across_decode(setup):
    """A decode step with ``kv_len == 0`` on slots 0 and 2 leaves their
    (conv, h) bit for bit; the live slots' state and logits match JAX."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(4)
    tcache = tkv.alloc_decode_cache(tcfg, 3, 16, "cpu")
    for leaf in tcache["ssm"]:
        leaf.copy_(torch.from_numpy(
            rng.randn(*leaf.shape).astype(np.float32) * 0.5))
    # copies: on the CPU ``jnp.asarray`` may alias the numpy view of the
    # port's cache, which the port's decode then updates in place while
    # the JAX step, dispatched asynchronously, may still be reading it
    jcache = {"ssm": jssm.SSMState(*(jnp.array(t.numpy())
                                     for t in tcache["ssm"]))}
    before = [t.clone() for t in tcache["ssm"]]
    tok = np.array([3, 7, 11], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    kvl = np.array([0, 6, 0], np.int32)
    lj, jcache = japi.model_fns(jcfg).forward_decode(
        jcfg, jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
        kv_len=jnp.asarray(kvl))
    lt, tcache = ttr.forward_decode(
        tcfg, tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
        kv_len=torch.from_numpy(kvl))
    for new, old in zip(tcache["ssm"], before):
        assert torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 2], old[:, 2])
        assert not torch.equal(new[:, 1], old[:, 1])
    _close(lt[1], np.asarray(lj)[1], LOGIT_ATOL)
    for got, want in zip(tcache["ssm"], jcache["ssm"]):
        _close(got, want)


def test_init_modes_and_dtypes():
    """``init_params`` draws the mamba1 leaves by their initializers (as
    the JAX package's ``_init_one``) and keeps ``a_log`` and ``d_skip`` in
    float32 under bf16 weights; ``params_from_numpy`` does the same."""
    cfg = tconfigs.get_smoke(ARCH)                  # bf16 activations
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m = p["blocks"]["mamba"]
    n_layers, di, ds = cfg.n_layers, cfg.d_inner, cfg.ssm_state
    assert m["a_log"].dtype == m["d_skip"].dtype == torch.float32
    assert m["in_proj"].dtype == torch.bfloat16
    want_a = torch.log(torch.arange(1, ds + 1, dtype=torch.float32))
    assert torch.equal(m["a_log"], want_a.expand(n_layers, di, ds))
    assert torch.equal(m["d_skip"], torch.ones(n_layers, di))
    assert not m["conv_b"].any()
    dt = torch.nn.functional.softplus(m["dt_bias"].float())
    assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.1 * 1.01
    bound = n_layers ** -0.5           # the leading axis, as the reference
    conv = m["conv_w"].float()
    assert float(conv.abs().max()) <= bound and float(conv.std()) > 0.1
    jp = jinit(jconfigs.get_smoke(ARCH), jax.random.key(0))
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                                dtype=torch.bfloat16)["blocks"]["mamba"]
    assert carried["a_log"].dtype == carried["d_skip"].dtype == torch.float32
    assert carried["wb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        carried["a_log"].numpy(), np.asarray(jp["blocks"]["mamba"]["a_log"]))
