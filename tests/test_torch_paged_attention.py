"""Port parity: attention over the paged KV pool and the int8 cache
against the JAX package.

On the CPU the attention wrappers run their plain versions
(``kernels/ref.py``).  On the paged pool and on int8 caches they are held
against the JAX package's Pallas kernels in interpret mode and its ``ref``
path at atol 1e-5, in float32 (both sides compute f32 softmax attention
over the same inputs, in another summation order), over GQA ratios 1, 2
and 4, pool blocks of 8 and 16 entries, scrambled block tables, poisoned
unmapped blocks, idle slots and pad query rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import Int8KV as JInt8KV
from repro.kernels import ops as jops
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ATOL = 1e-5


def _paged_case(rng, b, n_tbl, nb, bs, hkv, d, fills, int8):
    """Scrambled placement, as ``tests/test_paged_kv.py`` builds it: slot
    rows map to a shuffled set of pool blocks; entries outside any live
    region keep poisoned (valid-looking) positions and random values, and
    table entries past a slot's live blocks name block 0."""
    k = rng.randn(nb, bs, hkv, d).astype(np.float32)
    v = rng.randn(nb, bs, hkv, d).astype(np.float32)
    pos = rng.randint(0, 3, (nb, bs)).astype(np.int32)
    table = np.zeros((b, n_tbl), np.int32)
    order = rng.permutation(nb)
    nxt = 0
    for i, fill in enumerate(fills):
        for j in range(-(-fill // bs)):
            blk = int(order[nxt])
            nxt += 1
            table[i, j] = blk
            n = min(bs, fill - j * bs)
            pos[blk, :n] = np.arange(j * bs, j * bs + n)
            pos[blk, n:] = -1
    scales = (None, None)
    if int8:
        k = rng.randint(-127, 128, k.shape).astype(np.int8)
        v = rng.randint(-127, 128, v.shape).astype(np.int8)
        scales = _scales(rng, (nb, bs, hkv))
    return k, v, scales, pos, table, np.asarray(fills, np.int32)


def _scales(rng, shape):
    """K and V scales as ``quant_kv`` makes them, amax / 127, for values
    of about unit size (so f32 summation order stays below 1e-5)."""
    return tuple((rng.uniform(0.5, 2.0, shape) / 127.0).astype(np.float32)
                 for _ in range(2))


def _caches(k, v, scales):
    """The same K/V as JAX and port cache arguments."""
    if scales[0] is None:
        return (jnp.asarray(k), jnp.asarray(v),
                torch.from_numpy(k), torch.from_numpy(v))
    ks, vs = scales
    return (JInt8KV(jnp.asarray(k), jnp.asarray(ks)),
            JInt8KV(jnp.asarray(v), jnp.asarray(vs)),
            tq.Int8KV(torch.from_numpy(k), torch.from_numpy(ks)),
            tq.Int8KV(torch.from_numpy(v), torch.from_numpy(vs)))


def _port_and_jax(fn_name, q, caches, qp, pos, kvl, table):
    jk, jv, tk, tv = caches
    t_tab = None if table is None else torch.from_numpy(table)
    j_tab = None if table is None else jnp.asarray(table)
    port = getattr(tops, fn_name)(
        torch.from_numpy(q), tk, tv, torch.from_numpy(qp),
        torch.from_numpy(pos), kv_len=torch.from_numpy(kvl),
        block_table=t_tab).numpy()
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(qp), jnp.asarray(pos))
    out = [np.asarray(getattr(jops, fn_name)(
        *jargs, kv_len=jnp.asarray(kvl), block_table=j_tab, force=force))
        for force in ("interpret", "ref")]
    return port, out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv", [4, 2, 1])      # GQA ratios 1, 2, 4
def test_paged_decode_matches_jax(hkv, int8):
    for bs in (8, 16):
        rng = np.random.RandomState(bs + hkv)
        fills = [5, 0, 32, 17]                   # ragged, idle, full
        k, v, scales, pos, table, kvl = _paged_case(
            rng, 4, 32 // bs, 12, bs, hkv, 16, fills, int8)
        q = rng.randn(4, 1, 4, 16).astype(np.float32)
        qp = np.maximum(kvl - 1, 0).astype(np.int32)
        port, (interp, jref) = _port_and_jax(
            "decode_attention", q, _caches(k, v, scales), qp, pos, kvl,
            table)
        np.testing.assert_allclose(port, interp, atol=ATOL)
        np.testing.assert_allclose(port, jref, atol=ATOL)
        assert np.all(port[1] == 0)              # idle slot: exact zeros


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_paged_chunk_matches_jax(hkv, int8):
    for bs in (8, 16):
        rng = np.random.RandomState(10 + bs + hkv)
        fills = [8, 20, 12]                      # post-write fills p + C
        k, v, scales, pos, table, kvl = _paged_case(
            rng, 3, 32 // bs, 10, bs, hkv, 16, fills, int8)
        qp = np.full((3, 4), -1, np.int32)
        for i, (f, r) in enumerate(zip(fills, (4, 4, 2))):
            qp[i, :r] = np.arange(f - r, f)
        q = rng.randn(3, 4, 4, 16).astype(np.float32)
        port, (interp, jref) = _port_and_jax(
            "chunk_attention", q, _caches(k, v, scales), qp, pos, kvl,
            table)
        np.testing.assert_allclose(port, interp, atol=ATOL)
        np.testing.assert_allclose(port, jref, atol=ATOL)
        assert np.all(port[2, 2:] == 0)          # pad query rows


@pytest.mark.parametrize("fn_name", ["decode_attention", "chunk_attention"])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_int8_contiguous_matches_jax(fn_name, hkv):
    """Int8KV on the slot-contiguous layout, at kv_len {0, partial, S}."""
    rng = np.random.RandomState(20 + hkv)
    b, s, c = 3, 40, (1 if fn_name == "decode_attention" else 4)
    k = rng.randint(-127, 128, (b, s, hkv, 16)).astype(np.int8)
    v = rng.randint(-127, 128, (b, s, hkv, 16)).astype(np.int8)
    scales = _scales(rng, (b, s, hkv))
    kvl = np.asarray([0, 13, s], np.int32)
    pos = np.where(np.arange(s)[None] < kvl[:, None], np.arange(s)[None],
                   -1).astype(np.int32)
    qp = np.full((b, c), -1, np.int32)
    for i, (f, r) in enumerate(zip(kvl, (0, c, c - 1))):
        qp[i, :r] = np.arange(f - r, f)
    q = rng.randn(b, c, 4, 16).astype(np.float32)
    if c == 1:
        qp = np.maximum(kvl - 1, 0).astype(np.int32)
    port, (interp, jref) = _port_and_jax(
        fn_name, q, _caches(k, v, scales), qp, pos, kvl, None)
    np.testing.assert_allclose(port, interp, atol=ATOL)
    np.testing.assert_allclose(port, jref, atol=ATOL)
    assert np.all(port[0] == 0)
