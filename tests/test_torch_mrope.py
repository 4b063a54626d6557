"""Port parity: M-RoPE (Qwen2-VL's three-stream rotary embedding) against
the JAX package, on the CPU.

``apply_mrope`` and ``position_encode`` against ``repro.models.layers``
on the same numpy inputs, the decode and chunk layers' broadcast of
their one-stream positions to three equal streams (``layers.py:386-389``,
``:542-545``), the whole-sequence layer on an image's positions, and the
three-stream default positions, all in float32 on one layer of the
qwen2-vl smoke weights (int8 too for the cache layers).  Tolerances:
float32 rotations and sums in another order, 1e-5 (rotations alone
1e-6); int8 1e-4 (a last-bit difference moves an activation across a
rounding boundary of its quantizer).
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
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.core import quantize as tq
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
ROT_ATOL = 1e-6
ATOL = 1e-5
INT8_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jp = jinit(jcfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _image_positions(b):
    """(B, S, 3): 3 text tokens, a 1 x 3 x 4 image, 5 text tokens; row b
    shifted by 7 b (positions past the sequence's own length)."""
    one = tapi.mrope_positions([("text", 3), ("image", (1, 3, 4)),
                                ("text", 5)]).numpy()
    return np.stack([one + 7 * i for i in range(b)]).astype(np.int32)


# (leading shape, head dim, sections, theta)
_ROT_CASES = [((2, 20, 4), 16, (2, 3, 3), 1e4),
              ((1, 33, 8), 128, (16, 24, 24), 1e6),
              ((3, 1, 2), 32, (4, 6, 6), 1e6)]


@pytest.mark.parametrize("case", _ROT_CASES, ids=lambda c: f"d{c[1]}")
def test_apply_mrope_matches_jax(case):
    """Random x and three independent random streams (up to 2^12, beyond
    the sequences of the chip run)."""
    (b, s, h), d, sections, theta = case
    rng = np.random.RandomState(d)
    x = rng.randn(b, s, h, d).astype(np.float32)
    pos = rng.randint(0, 2 ** 12, size=(b, s, 3)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                               sections)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROT_ATOL,
                               rtol=1e-5)


def test_apply_mrope_bf16_matches_jax():
    """bf16 x, rotated in f32 and rounded once, as the reference: equal
    up to one bf16 rounding of the result (2^-8 of its size)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 4, 16).astype(np.float32)
    pos = _image_positions(2)[:, :9]
    want = jlayers.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                               1e4, (2, 3, 3))
    got = tlayers.apply_mrope(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(pos), 1e4, (2, 3, 3))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=2.0 ** -8)


def test_mrope_equal_streams_is_rope():
    """Three equal streams rotate as the one-stream RoPE does, on both
    sides: a text token's M-RoPE is its RoPE."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 4, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32) * 3, (2, 11))
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              1e4, (2, 3, 3))
    rope = tlayers.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), 1e4)
    np.testing.assert_allclose(got.numpy(), rope.numpy(), atol=ROT_ATOL)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                               (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROT_ATOL)


def test_mrope_streams_rotate_their_own_sections():
    """Moving one stream changes exactly its section's frequencies (both
    halves of each rotated pair), nothing else."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 4, 2, 16).astype(np.float32))
    pos = torch.zeros((1, 4, 3), dtype=torch.int32)
    base = tlayers.apply_mrope(x, pos, 1e4, (2, 3, 3))
    bounds = np.cumsum([0, 2, 3, 3])
    for stream in range(3):
        moved = pos.clone()
        moved[..., stream] = 5
        diff = (tlayers.apply_mrope(x, moved, 1e4, (2, 3, 3)) - base).abs()
        changed = diff.amax(dim=(0, 1, 2)) > 1e-6              # (D,)
        want = np.zeros(16, bool)
        lo, hi = bounds[stream], bounds[stream + 1]
        want[lo:hi] = want[8 + lo:8 + hi] = True
        np.testing.assert_array_equal(changed.numpy(), want)


def test_mrope_sections_must_cover_half_the_head():
    x = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(x, torch.zeros(1, 2, 3, dtype=torch.int32), 1e4,
                            (2, 3, 4))


@pytest.mark.parametrize("variant", ["mrope", "rope", "none"])
def test_position_encode_matches_jax(variant):
    """q and k of GQA shapes, positions (B, S, 3) for "mrope", (B, S)
    else."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 20, 4, 16).astype(np.float32)
    k = rng.randn(2, 20, 2, 16).astype(np.float32)
    pos3 = _image_positions(2)
    pos = pos3 if variant == "mrope" else pos3[..., 0].copy()
    wq, wk = jlayers.position_encode(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(pos), variant, 1e4,
                                     (2, 3, 3))
    gq, gk = tlayers.position_encode(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(pos), variant, 1e4,
                                     (2, 3, 3))
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=ROT_ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ROT_ATOL)


def test_default_positions_three_streams_match_jax(setup):
    jcfg, tcfg, _, _ = setup
    want = np.asarray(jtr.default_positions(jcfg, 3, 7))
    got = ttr.default_positions(3, 7, cfg=tcfg)
    assert got.dtype == torch.int32 and got.shape == (3, 7, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    rope = dataclasses.replace(tcfg, rope_variant="rope")
    assert ttr.default_positions(3, 7, cfg=rope).shape == (3, 7)


def test_mrope_positions_qwen2_vl_layout():
    """Text at i in all three streams, a 2 x 2 x 3 video patch grid at
    start + (t, h, w), text again from one past the largest id."""
    got = tapi.mrope_positions([("text", 2), ("image", (2, 2, 3)),
                                ("text", 2)]).numpy()
    assert got.shape == (2 + 12 + 2, 3)
    np.testing.assert_array_equal(got[:2], [[0, 0, 0], [1, 1, 1]])
    np.testing.assert_array_equal(got[2], [2, 2, 2])
    np.testing.assert_array_equal(got[2 + 11], [3, 3, 4])
    np.testing.assert_array_equal(got[-2:], [[5, 5, 5], [6, 6, 6]])
    with pytest.raises(ValueError, match="segment"):
        tapi.mrope_positions([("audio", 3)])


# ---------------------------------------------------------------------------
# The attention layers under M-RoPE
# ---------------------------------------------------------------------------
def _layer0(jp, tp, precision):
    if precision == "float":
        return (jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
                tp["blocks"].unstack()[0]["attn"], None, None)
    jpol, tpol = jq.policy_for(precision), tq.policy_for(precision)
    jq_tree = jq.quantize_model_params(jp, jpol)
    tq_tree = tq.quantize_model_params(tp, tpol)
    return (jax.tree.map(lambda a: a[0], jq_tree["blocks"]["attn"]),
            tq_tree["blocks"].unstack()[0]["attn"], jpol, tpol)


def _kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_variant=cfg.rope_variant,
                rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections)


def _caches(rng, cfg, b, s, precision):
    """A random cache of S rows on both sides (its first 6 rows live,
    positions 0..5; the rest −1), float or ``Int8KV``."""
    shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(2))
    pos = np.full((b, s), -1, np.int32)
    pos[:, :6] = np.arange(6)
    if precision == "int8":
        pairs = [tq.quant_kv(t) for t in (k, v)]
        jside = [jq.Int8KV(jnp.asarray(p.q.numpy()),
                           jnp.asarray(p.scale.numpy())) for p in pairs]
        return pairs, jside, pos
    return [k, v], [jnp.asarray(t.numpy()) for t in (k, v)], pos


def _leaves(c):
    return (c.q, c.scale) if isinstance(c, tq.Int8KV) else (c,)


def _assert_cache_equal(tcache, jcache, atol):
    jleaves = ((jcache.q, jcache.scale) if isinstance(jcache, jq.Int8KV)
               else (jcache,))
    for t, j in zip(_leaves(tcache), jleaves):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), atol=atol)


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_decode_layer_broadcasts_three_streams(setup, precision):
    """``attention_decode_layer`` under M-RoPE: the (B,) positions roped as
    three equal streams, against the JAX layer; the written K/V rows too."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, jpol, tpol = _layer0(jp, tp, precision)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
    (tk, tv), (jk, jv), pos = _caches(rng, tcfg, 2, 10, precision)
    position = np.array([6, 6], np.int32)
    pos[:, 6] = 6
    want, jk2, jv2, _ = jlayers.attention_decode_layer(
        jw, jnp.asarray(x), jnp.asarray(position), jk, jv, jnp.asarray(pos),
        jnp.asarray(position), policy=jpol, **_kw(jcfg))
    got = tlayers.attention_decode_layer(
        tw, torch.from_numpy(x), torch.from_numpy(position), tk, tv,
        torch.from_numpy(pos), torch.from_numpy(position), policy=tpol,
        **_kw(tcfg))
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    _assert_cache_equal(tk, jk2, atol)
    _assert_cache_equal(tv, jv2, atol)


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_chunk_layer_broadcasts_three_streams(setup, precision):
    """``attention_chunk_layer`` under M-RoPE: a chunk of 4 at positions 6
    to 9 (row 1 with a pad tail at −1) against the JAX layer, on the real
    rows; the written rows too."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, jpol, tpol = _layer0(jp, tp, precision)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, tcfg.d_model).astype(np.float32)
    (tk, tv), (jk, jv), pos = _caches(rng, tcfg, 2, 12, precision)
    chunk = np.array([[6, 7, 8, 9], [6, 7, -1, -1]], np.int32)
    pos[:, 6:10] = chunk
    kv_len = np.array([10, 10], np.int32)
    want, jk2, jv2, _ = jlayers.attention_chunk_layer(
        jw, jnp.asarray(x), jnp.asarray(chunk), jk, jv, jnp.asarray(pos),
        jnp.asarray(chunk[:, 0]), policy=jpol, kv_len=jnp.asarray(kv_len),
        **_kw(jcfg))
    got = tlayers.attention_chunk_layer(
        tw, torch.from_numpy(x), torch.from_numpy(chunk), tk, tv,
        torch.from_numpy(pos), torch.from_numpy(chunk[:, 0].copy()),
        policy=tpol, kv_len=torch.from_numpy(kv_len), **_kw(tcfg))
    real = chunk >= 0
    atol = ATOL if precision == "float" else INT8_ATOL
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=atol)
    _assert_cache_equal(tk, jk2, atol)
    _assert_cache_equal(tv, jv2, atol)


@pytest.mark.parametrize("by_position", [True, False],
                         ids=["image", "default"])
def test_attention_layer_three_streams_matches_jax(setup, by_position):
    """The whole-sequence layer on an image's positions (the kernel masked
    by their temporal stream) and on the default three equal streams (the
    index masks), against the JAX layer: output and the roped K/V."""
    jcfg, tcfg, jp, tp = setup
    jw, tw, _, _ = _layer0(jp, tp, "float")
    rng = np.random.RandomState(8)
    x = rng.randn(2, 20, tcfg.d_model).astype(np.float32)
    pos = (_image_positions(2) if by_position
           else np.asarray(jtr.default_positions(jcfg, 2, 20)))
    want, (wk, wv) = jlayers.attention_layer(
        jw, jnp.asarray(x), jnp.asarray(pos), **_kw(jcfg))
    got, (gk, gv) = tlayers.attention_layer(
        tw, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        mask_pos=(torch.from_numpy(pos[..., 0].copy()) if by_position
                  else None), **_kw(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL)
    if by_position:
        # the index masks would hide the patches' shared position
        by_index, _ = tlayers.attention_layer(
            tw, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            **_kw(tcfg))
        assert float((by_index - got).abs().max()) > 1e-3
