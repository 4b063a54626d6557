"""Port parity: cross-attention against the JAX package, on the CPU.

The plain whole-sequence attention with keys of another length than the
queries (``flash_attention_ref``, what ``ops.flash_attention`` runs on the
CPU) against the reference's jnp core ``full_attention`` (the core of its
enc-dec cross-attention; the Pallas kernel asserts one S), its autograd
against ``jax.grad``, and the refusal of index masks between two lengths.
Then the cross branch of each attention layer (whole sequence with
``kv_override``, decode and chunk with ``cross=True``) against the JAX
layer on one layer of the seamless-m4t smoke weights in float32, float
and int8: the query is never roped, the encoder's K/V are read whole and
never written, a pad query's row is exactly zero.  Last, the enc-dec
cache sizing of ``kv_cache_bytes`` and the int8 projections of the
encoder and the cross-attention.  Tolerances: float32 sums in another
order, 1e-5; int8 paths 1e-4 (a last-bit difference moves an activation
across a rounding boundary of its quantizer, measured below 2e-5).
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
from repro.models.params import init_params as jinit
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops, ref
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models.params import init_params as tinit
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import kvcache as tkv

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-5
INT8_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# The plain attention at Sq != Skv
# ---------------------------------------------------------------------------
def _qkv(rng, b, sq, skv, hq, hkv, d):
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


def _default_pos(b, s):
    return jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))


# (B, Sq, Skv, Hq, Hkv, D): the smoke decoder's cross (S 16 on S_enc 4),
# GQA, a ragged pair and more keys than queries
_SHAPES = [(2, 16, 4, 4, 4, 16), (2, 40, 10, 4, 2, 16),
           (1, 1000, 250, 2, 2, 64), (1, 7, 33, 2, 1, 32)]


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_attention_other_key_length_matches_jax(shape):
    """``ops.flash_attention(causal=False)`` on the CPU against the
    reference's ``full_attention`` with the default positions (every key
    visible), within ``ATOL``."""
    b, sq, skv, hq, hkv, d = shape
    q, k, v = _qkv(np.random.RandomState(sum(shape)), *shape)
    want = jlayers.full_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), _default_pos(b, sq),
                                  _default_pos(b, skv), causal=False)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False)
    assert got.shape == (b, sq, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", _SHAPES[1:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_attention_grads_match_jax(shape):
    """Autograd through the plain version (the CPU path of training)
    against ``jax.grad`` of ``full_attention``, and the plain backward
    ``flash_attention_bwd_ref`` against the autograd: dq of q's shape,
    dk/dv of k's, within ``ATOL``."""
    b, sq, skv, hq, hkv, d = shape
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, *shape)
    w = rng.randn(b, sq, hq, d).astype(np.float32)

    def jloss(q, k, v):
        o = jlayers.full_attention(q, k, v, _default_pos(b, sq),
                                   _default_pos(b, skv), causal=False)
        return jnp.sum(o * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq_, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq_, tk, tv, causal=False)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq_, tk, tv))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)
    plain = ref.flash_attention_bwd_ref(
        *(x.detach() for x in (tq_, tk, tv, out)), torch.from_numpy(w),
        causal=False)
    for p, g in zip(plain, got):
        assert p.shape == g.shape
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_other_key_length_refused_under_an_index_mask(causal, window):
    """A diagonal or a window between two lengths means nothing: the CPU
    path, its backward and the layer all raise."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.RandomState(0), 1, 12, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="causal=False"):
        ops.flash_attention(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="causal=False"):
        ref.flash_attention_bwd_ref(q, k, v, q, q, causal=causal,
                                    window=window)


# ---------------------------------------------------------------------------
# The three cross branches against the JAX layers
# ---------------------------------------------------------------------------
def _layer0(jp, tp, precision):
    """Layer 0's ``xattn`` weights on both sides, float or int8, and the
    two policies."""
    if precision == "float":
        return (jax.tree.map(lambda a: a[0], jp["blocks"]["xattn"]),
                tp["blocks"].unstack()[0]["xattn"], None, None)
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    jq_tree = jq.quantize_model_params(jp, jpol)
    tq_tree = tq.quantize_model_params(tp, tpol)
    return (jax.tree.map(lambda a: a[0], jq_tree["blocks"]["xattn"]),
            tq_tree["blocks"].unstack()[0]["xattn"], jpol, tpol)


def _kw(cfg, rope_variant=None):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                rope_variant=rope_variant or cfg.rope_variant,
                rope_theta=cfg.rope_theta)


def _enc_kv(rng, cfg, b, s_enc, precision):
    """Encoder K/V of (B, S_enc, Hkv, D) in the cache's representation:
    float, ``Int8KV`` (native int8) or the round trip (fake-quant), the
    same values on both sides."""
    shape = (b, s_enc, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(2))
    if precision == "int8":
        pairs = [tq.quant_kv(t) for t in (k, v)]
        jax_side = [jq.Int8KV(jnp.asarray(p.q.numpy()),
                              jnp.asarray(p.scale.numpy())) for p in pairs]
        return pairs, jax_side
    if precision == "int8_fakequant":
        k, v = (tq.dequant_kv(tq.quant_kv(t)) for t in (k, v))
    return [k, v], [jnp.asarray(t.numpy()) for t in (k, v)]


def _snapshot(leaves):
    return [tuple(t.clone() for t in x) if isinstance(x, tuple)
            else x.clone() for x in leaves]


def _assert_unchanged(leaves, before):
    for now, then in zip(leaves, before):
        for a, b in zip(now if isinstance(now, tuple) else (now,),
                        then if isinstance(then, tuple) else (then,)):
            assert torch.equal(a, b)


_PRECISIONS = ["float", "int8", "int8_fakequant"]


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_attention_layer_kv_override_matches_jax(setup, precision):
    """The whole-sequence branch: S 16 queries on S_enc 4 keys given as
    they are (the enc-dec decoder passes ``rope_variant="none"``), and a
    roped query where a caller asks for it, both as the JAX layer."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, jpol, tpol = _layer0(jp, tp, precision)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, tcfg.d_model).astype(np.float32)
    (k, v), _ = _enc_kv(rng, tcfg, 2, 4, "float")
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    atol = ATOL if precision == "float" else INT8_ATOL
    for rope in ("none", "rope"):
        want, _ = jlayers.attention_layer(
            jw, jnp.asarray(x), jnp.asarray(pos), causal=False,
            kv_override=(jnp.asarray(k.numpy()), jnp.asarray(v.numpy())),
            kv_positions=_default_pos(2, 4), policy=jpol,
            mrope_sections=jcfg.mrope_sections, **_kw(jcfg, rope))
        got, (gk, gv) = tlayers.attention_layer(
            tw, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            causal=False, kv_override=(k, v), policy=tpol,
            **_kw(tcfg, rope))
        assert gk is k and gv is v
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_cross_decode_matches_jax_and_writes_nothing(setup, precision):
    """``attention_decode_layer(cross=True)``: three rows, one of them an
    idle slot's (position 0), at positions that a roped query would turn
    (the config's ``rope``: the branch returns before any rope), against
    the JAX layer; the encoder K/V and their positions bitwise unchanged."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, jpol, tpol = _layer0(jp, tp, precision)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, tcfg.d_model).astype(np.float32)
    (tk, tv), (jk, jv) = _enc_kv(rng, tcfg, 3, 6, precision)
    enc_pos = torch.arange(6, dtype=torch.int32)[None].repeat(3, 1)
    position = np.array([5, 17, 0], np.int32)
    before = _snapshot([tk, tv, enc_pos])
    want, *_ = jlayers.attention_decode_layer(
        jw, jnp.asarray(x), jnp.asarray(position), jk, jv,
        jnp.asarray(enc_pos.numpy()), jnp.asarray(position), cross=True,
        policy=jpol, mrope_sections=jcfg.mrope_sections, **_kw(jcfg))
    got = tlayers.attention_decode_layer(
        tw, torch.from_numpy(x), torch.from_numpy(position), tk, tv,
        enc_pos, torch.from_numpy(position), cross=True, policy=tpol,
        **_kw(tcfg))
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    _assert_unchanged([tk, tv, enc_pos], before)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_cross_chunk_matches_jax_pad_rows_zero(setup, precision,
                                               monkeypatch):
    """``attention_chunk_layer(cross=True)``: a chunk of 6 at positions 9
    to 14 (row 0) and 3 real queries with a pad tail (row 1): the real
    rows against the JAX layer, every pad query's attention row exactly
    zero before ``wo``, and the encoder K/V bitwise unchanged."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, jpol, tpol = _layer0(jp, tp, precision)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, tcfg.d_model).astype(np.float32)
    (tk, tv), (jk, jv) = _enc_kv(rng, tcfg, 2, 5, precision)
    enc_pos = torch.arange(5, dtype=torch.int32)[None].repeat(2, 1)
    pos = np.array([[9, 10, 11, 12, 13, 14], [0, 1, 2, -1, -1, -1]],
                   np.int32)
    before = _snapshot([tk, tv, enc_pos])
    seen = []
    chunk_attention = tlayers.chunk_attention

    def recording(*args, **kwargs):
        seen.append(chunk_attention(*args, **kwargs))
        return seen[-1]
    monkeypatch.setattr(tlayers, "chunk_attention", recording)
    want, *_ = jlayers.attention_chunk_layer(
        jw, jnp.asarray(x), jnp.asarray(pos), jk, jv,
        jnp.asarray(enc_pos.numpy()), jnp.asarray(pos[:, 0]), cross=True,
        policy=jpol, mrope_sections=jcfg.mrope_sections,
        **_kw(jcfg, "none"))
    got = tlayers.attention_chunk_layer(
        tw, torch.from_numpy(x), torch.from_numpy(pos), tk, tv, enc_pos,
        torch.from_numpy(pos[:, 0].copy()), cross=True, policy=tpol,
        **_kw(tcfg, "none"))
    real = pos >= 0
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=atol)
    o, = seen
    assert torch.count_nonzero(o[torch.from_numpy(~real)]) == 0
    assert torch.count_nonzero(o[torch.from_numpy(real)]) > 0
    _assert_unchanged([tk, tv, enc_pos], before)


def test_cross_query_is_not_roped(setup):
    """The chunk branch with the config's ``rope`` differs from the
    decoder's ``"none"`` at every position but 0: the two differ, so the
    comparisons above, all at positions past 0, tell a roped query
    apart."""
    _, tcfg, _, tp = setup
    tw = tp["blocks"].unstack()[0]["xattn"]
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, tcfg.d_model).astype(np.float32))
    (k, v), _ = _enc_kv(rng, tcfg, 1, 3, "float")
    enc_pos = torch.arange(3, dtype=torch.int32)[None]
    pos = torch.arange(4, dtype=torch.int32)[None]
    outs = [tlayers.attention_chunk_layer(
        tw, x, pos, k, v, enc_pos, pos[:, 0], cross=True,
        **_kw(tcfg, rope)) for rope in ("none", "rope")]
    torch.testing.assert_close(outs[0][:, 0], outs[1][:, 0])
    gaps = (outs[0] - outs[1]).abs().amax(dim=-1)[0, 1:]
    assert bool((gaps > 1e-4).all())


# ---------------------------------------------------------------------------
# Sizing and quantization
# ---------------------------------------------------------------------------
def test_kv_cache_bytes_encdec_matches_jax_sizing():
    """``tests/test_serve.py::test_kv_cache_bytes_encdec_sizing``: the
    decoder's self K/V over S and the cross K/V over S // 4, no encoder
    cache; int8 as the JAX package prices it; and the leaves of the port's
    own prefill cache carry exactly those bytes."""
    cfg = tconfigs.get(ARCH)
    b, s, db = 2, 1024, 2
    per_entry = 2 * b * cfg.n_kv_heads * cfg.resolved_head_dim * db
    expect = (cfg.n_layers * per_entry * s
              + cfg.n_layers * per_entry * (s // cfg.enc_seq_divisor))
    assert tkv.kv_cache_bytes(cfg, b, s, db) == expect
    jcfg = jconfigs.get(ARCH)
    assert tkv.kv_cache_bytes(cfg, b, s, db, precision="int8") == \
        jkv.kv_cache_bytes(jcfg, b, s, db, precision="int8")
    smoke = tconfigs.get_smoke(ARCH)
    params = tinit(smoke, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    inputs = {"tokens": torch.randint(0, 320, (2, 16), generator=gen),
              "enc_embeddings": torch.randn(2, 4, 64, generator=gen)}
    _, cache = ted.forward_prefill(smoke, params, inputs)
    kv_bytes = sum(cache[key].numel() * cache[key].element_size()
                   for key in ted.KV_KEYS)
    assert kv_bytes == tkv.kv_cache_bytes(smoke, 2, 16,
                                          cache["k"].element_size())


def test_int8_quantizes_encoder_and_cross_projections():
    """Under int8 (``QUANT_SCOPES`` holds ``xattn``) the encoder's and the
    decoder's attention and MLP projections and the cross-attention's four
    become ``QTensor``s, bitwise the JAX package's values and scales; the
    norms and embeddings stay float."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jqp = jq.quantize_model_params(jp, jq.INT8)
    tqp = tq.quantize_model_params(tp, tq.INT8)
    for stack in ("enc_blocks", "blocks"):
        scopes = ("attn", "mlp") + (("xattn",) if stack == "blocks" else ())
        for scope in scopes:
            for name, leaf in tqp[stack][scope].tree().items():
                assert isinstance(leaf, tq.QTensor), (stack, scope, name)
                jleaf = jqp[stack][scope][name]
                np.testing.assert_array_equal(
                    leaf.q.numpy(), np.swapaxes(np.asarray(jleaf.q), -1, -2))
                np.testing.assert_array_equal(leaf.scale.numpy(),
                                              np.asarray(jleaf.scale))
    for name in ("enc_final_norm", "final_norm", "embed", "unembed"):
        assert isinstance(tqp[name], torch.Tensor)
    assert isinstance(tqp["blocks"]["xattn_norm"], torch.Tensor)
