"""Port parity: configs, weights, decode cache and the model's serving
entry points against the JAX package.

All on the CPU, on the ``internlm2-1.8b`` smoke config with a float32
override.  The JAX package's own ``init_params`` weights are carried
across with ``params_from_numpy``.  Logits and caches of
``forward_prefill_chunk`` and ``forward_decode`` must agree at atol 1e-4:
both sides run the same float32 arithmetic, in another summation order
(measured gap about 2e-7).
"""
import dataclasses

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
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params as tinit
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
ATOL = 1e-4
_PROPS = ("resolved_head_dim", "d_inner", "resolved_ssm_heads",
          "uses_attention", "is_moe", "is_ssm_only", "sub_quadratic")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# the dense config under its earlier ids, the two MoE configs, the enc-dec
# config and the VLM
_CONFIG_CASES = [(ARCH, "get"), (ARCH, "get_smoke")] + [
    (arch, getter) for arch in ("phi3.5-moe-42b-a6.6b", "dbrx-132b",
                                "seamless-m4t-large-v2", "qwen2-vl-72b")
    for getter in ("get", "get_smoke")]
# the parameter counts of the MoE, enc-dec and VLM configs at full width
_FULL_PARAMS = {"phi3.5-moe-42b-a6.6b": 41_878_028_288,
               "dbrx-132b": 131_596_025_856,
               "seamless-m4t-large-v2": 2_038_431_744,
               "qwen2-vl-72b": 72_729_231_360}


@pytest.mark.parametrize("arch,getter", _CONFIG_CASES,
                         ids=[g if a == ARCH else f"{a}-{g}"
                              for a, g in _CONFIG_CASES])
def test_arch_config_matches_jax(arch, getter):
    jc = getattr(jconfigs, getter)(arch)
    tc = getattr(tconfigs, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tconfigs.comes_with(arch) is None
    if arch in _FULL_PARAMS and getter == "get":
        assert tc.param_count() == _FULL_PARAMS[arch]
    for prop in _PROPS:
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.padded_vocab() == jc.padded_vocab()
    assert tc.param_count() == jc.param_count()
    assert tc.activation_dtype == getattr(torch, str(jc.activation_dtype))


def test_unported_arch_raises():
    """Named for the refusal it checked until the last config, qwen2-vl,
    was ported: now no id of ``ALIASES`` raises, each loads the
    reference's configs and ``comes_with`` returns None."""
    for arch in tconfigs.ALIASES:
        assert tconfigs.comes_with(arch) is None, arch
        for getter in ("get", "get_smoke"):
            got = getattr(tconfigs, getter)(arch)
            want = getattr(jconfigs, getter)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch


def test_int8_leaves_moe_banks_and_router_float():
    """As the JAX package's ``QUANT_SCOPES`` (``tests/test_precision.py``):
    under int8 the attention projections become ``QTensor``s, the
    experts' router and banks stay float tensors, shared with the float
    tree."""
    cfg = tconfigs.get_smoke("dbrx-132b")
    params = tinit(cfg, torch.Generator().manual_seed(1), "cpu")
    qp = tq.quantize_model_params(params, tq.INT8)
    assert isinstance(qp["blocks"]["attn"]["wq"], tq.QTensor)
    for name in ("router", "w_gate", "w_up", "w_down"):
        leaf = qp["blocks"]["moe"][name]
        assert isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
        assert leaf.data_ptr() == params["blocks"]["moe"][name].data_ptr()


def test_init_params_tree_matches_jax():
    """Same tree, shapes and leaf kinds as the JAX package's weights."""
    cfg = tconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jinit(jconfigs.get_smoke(ARCH),
                                        jax.random.key(0)))
    tp = tinit(cfg, torch.Generator().manual_seed(0), "cpu")

    def walk(j, t, path=""):
        assert set(j) == {n for n, _ in t.named_children()} | \
            {n for n, _ in t.named_parameters(recurse=False)}, path
        for key, val in j.items():
            if isinstance(val, dict):
                walk(val, t[key], f"{path}/{key}")
            else:
                leaf = t[key]
                assert tuple(leaf.shape) == val.shape, f"{path}/{key}"
                assert leaf.dtype == (torch.float32 if val.ndim < 2
                                      else torch.bfloat16), f"{path}/{key}"
                assert not leaf.requires_grad
                if not val.any():          # norm scales start at zero
                    assert not leaf.any()
    walk(jp, tp)
    assert sum(p.numel() for p in tp.parameters()) == \
        jparams.param_count(jconfigs.get_smoke(ARCH))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_alloc_decode_cache_matches_jax(dtype):
    jc = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
    jcache = jkv.alloc_decode_cache(jc, 3, 40)
    tcache = tkv.alloc_decode_cache(tc, 3, 40, "cpu")
    assert set(tcache) == set(jcache)
    for key, arr in jcache.items():
        t = tcache[key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype).removeprefix("torch.") == str(arr.dtype), key
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(arr, np.float32))
    assert tkv.decode_cache_nbytes(tcache) == jkv.decode_cache_nbytes(jcache)
    assert tkv.kv_cache_bytes(tc, 3, 40) == jkv.kv_cache_bytes(jc, 3, 40)


def _assert_cache_close(jcache, tcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=ATOL)
    np.testing.assert_array_equal(tcache["full_pos"].numpy(),
                                  np.asarray(jcache["full_pos"]))


def test_forward_chunk_and_decode_match_jax(setup):
    """Two prefill chunks (the second ragged, with pad rows) on a 3-row
    cache, then two decode steps with one idle row (kv_len 0): logits
    and the whole cache agree after every step."""
    jcfg, tcfg, jp, tp = setup
    b, cap, c = 3, 40, 8
    jcache = jkv.alloc_decode_cache(jcfg, b, cap)
    tcache = tkv.alloc_decode_cache(tcfg, b, cap, "cpu")
    rng = np.random.RandomState(0)
    reals = [(8, 8, 3), (8, 5, 1)]      # real tokens per row, per chunk
    start = np.zeros(b, np.int32)
    for chunk_reals in reals:
        toks = rng.randint(0, tcfg.vocab_size, (b, c)).astype(np.int32)
        pos = np.full((b, c), -1, np.int32)
        for i, r in enumerate(chunk_reals):
            pos[i, :r] = start[i] + np.arange(r)
        kvl = (start + c).astype(np.int32)
        jl, jcache = jtr.forward_prefill_chunk(
            jcfg, jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
            kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_prefill_chunk(
            tcfg, tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _assert_cache_close(jcache, tcache)
        start += np.array(chunk_reals, np.int32)
    position = start.copy()
    for _ in range(2):
        tok = rng.randint(0, tcfg.vocab_size, b).astype(np.int32)
        kvl = np.where(np.arange(b) == 2, 0, position + 1).astype(np.int32)
        jl, jcache = jtr.forward_decode(
            jcfg, jp, jcache, jnp.asarray(tok), jnp.asarray(position),
            kv_len=jnp.asarray(kvl))
        tl, tcache = ttr.forward_decode(
            tcfg, tp, tcache, torch.from_numpy(tok),
            torch.from_numpy(position), kv_len=torch.from_numpy(kvl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _assert_cache_close(jcache, tcache)
        position = position + 1


def test_slot_view_writes_in_place(setup):
    """A chunk run on ``take_slot``'s views lands in the big cache, and
    equals the JAX take/put round trip; release and reset are in place."""
    jcfg, tcfg, jp, tp = setup
    jbig = jkv.alloc_decode_cache(jcfg, 2, 16)
    tbig = tkv.alloc_decode_cache(tcfg, 2, 16, "cpu")
    toks = np.arange(1, 9, dtype=np.int32)[None]
    pos = np.arange(8, dtype=np.int32)[None]
    kvl = np.array([8], np.int32)
    axes = jkv.slot_batch_axes(jcfg, 2, 16)
    _, small = jtr.forward_prefill_chunk(
        jcfg, jp, jkv.take_slot(jbig, axes, 1), jnp.asarray(toks),
        jnp.asarray(pos), kv_len=jnp.asarray(kvl))
    jbig = jkv.put_slot(jbig, small, axes, 1)
    ttr.forward_prefill_chunk(tcfg, tp, tkv.take_slot(tbig, 1),
                              torch.from_numpy(toks), torch.from_numpy(pos),
                              kv_len=torch.from_numpy(kvl))
    _assert_cache_close(jbig, tbig)
    assert not tbig["k"][:, 0].any()          # the other slot is untouched
    _assert_cache_close(jkv.release_slot(jbig, 1),
                        tkv.release_slot(tbig, 1))
    tkv.put_slot(tbig, tkv.alloc_decode_cache(tcfg, 1, 16, "cpu"), 1)
    assert not tbig["k"].any() and bool((tbig["full_pos"] == -1).all())


@pytest.mark.parametrize("precision,paged", [("int8", False),
                                             ("float", True),
                                             ("int8", True),
                                             ("int8_fakequant", True)])
def test_forward_int8_and_paged_match_jax(setup, precision, paged):
    """The chunk and decode entry points under an int8 policy (QTensor
    weights, Int8KV or fake-quant cache) and on the paged pool (a
    scrambled block table of 8-entry blocks over three rows): the same
    two chunks and two decode steps as above give JAX's logits, and the
    same stored positions, after every step."""
    jcfg, tcfg, jp, tp = setup
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    jp, tp = jq.quantize_model_params(jp, jpol), \
        tq.quantize_model_params(tp, tpol)
    b, cap, c, bs = 3, 40, 8, 8
    rng = np.random.RandomState(1)
    if paged:
        table = rng.permutation(16)[:b * cap // bs].reshape(b, -1) \
            .astype(np.int32)
        jcache = jkv.alloc_paged_cache(jcfg, b, cap, 16, jpol, bs)
        tcache = tkv.alloc_paged_cache(tcfg, b, cap, 16, "cpu", tpol, bs)
        jt, tt, pos_key = (jnp.asarray(table), torch.from_numpy(table),
                           "pool_pos")
    else:
        jcache = jkv.alloc_decode_cache(jcfg, b, cap, jpol)
        tcache = tkv.alloc_decode_cache(tcfg, b, cap, "cpu", tpol)
        jt, tt, pos_key = None, None, "full_pos"

    def same(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_array_equal(tcache[pos_key].numpy(),
                                      np.asarray(jcache[pos_key]))

    start = np.zeros(b, np.int32)
    for chunk_reals in [(8, 8, 3), (8, 5, 1)]:
        toks = rng.randint(0, tcfg.vocab_size, (b, c)).astype(np.int32)
        pos = np.full((b, c), -1, np.int32)
        for i, r in enumerate(chunk_reals):
            pos[i, :r] = start[i] + np.arange(r)
        kvl = (start + c).astype(np.int32)
        jl, jcache = jtr.forward_prefill_chunk(
            jcfg, jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
            policy=jpol, kv_len=jnp.asarray(kvl), block_table=jt)
        tl, tcache = ttr.forward_prefill_chunk(
            tcfg, tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            policy=tpol, kv_len=torch.from_numpy(kvl), block_table=tt)
        same(jl, tl)
        start += np.array(chunk_reals, np.int32)
    position = start.copy()
    for _ in range(2):
        tok = rng.randint(0, tcfg.vocab_size, b).astype(np.int32)
        kvl = np.where(np.arange(b) == 2, 0, position + 1).astype(np.int32)
        jl, jcache = jtr.forward_decode(
            jcfg, jp, jcache, jnp.asarray(tok), jnp.asarray(position),
            policy=jpol, kv_len=jnp.asarray(kvl), block_table=jt)
        tl, tcache = ttr.forward_decode(
            tcfg, tp, tcache, torch.from_numpy(tok),
            torch.from_numpy(position), policy=tpol,
            kv_len=torch.from_numpy(kvl), block_table=tt)
        same(jl, tl)
        position = position + 1
