"""The attention kernels' head-dim contract on the CPU: any D that is a
multiple of 16 from 16 to 256, computed on tiles of 64, 128 or 256.

The plans (``flash_decode._plan``, ``tile_dim``, ``_smem``;
``flash_attention.column_blocks``) at D 16, 32, 48, 96, 112, 160, 192 and
256: each tile is the least that holds D and covers D's real columns
once, in whole 16-byte chunks in every type and whole lane shares of the
CUDA-core layout; shared memory stays within the H100's 232,448 bytes a
block.  Any other D is refused with a ``ValueError`` that states the rule.

The plain versions (the CPU path of ``kernels/ops.py``) against the JAX
package's Pallas kernels in interpret mode and its ``ref`` path at D 16
(every smoke config), 32 and 96, in f32 at atol 1e-5 (another summation
order): the serving attention over contiguous and paged caches, float and
int8; the whole-sequence forward, and the plain backward against
``jax.grad`` of the JAX reference (atol 2e-5).  Inputs are made with numpy
from a seed.
The kernels themselves are held against these plain versions on the card
(``tests/test_torch_head_dims_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import Int8KV as JInt8KV
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jfa_kernel
from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

DIMS = (16, 32, 48, 96, 112, 160, 192, 256)
SMEM_MAX = 232_448
ATOL = 1e-5


def test_tile_is_the_least_that_holds_the_head():
    for d in range(16, 257, 16):
        t = fd.tile_dim(d)
        assert t in fd.TILE_DIMS and d <= t
        assert all(w < d for w in fd.TILE_DIMS if w < t)


def test_other_head_dims_raise_with_the_rule():
    for d in (0, 8, 24, 40, 100, 250, 272, 320):
        with pytest.raises(ValueError,
                           match="multiple of 16 from 16 to 256"):
            fd.check_head_dim(d)
        with pytest.raises(ValueError, match="multiple of 16"):
            fd.tile_dim(d)


@pytest.mark.parametrize("d", DIMS)
def test_tiles_and_plans_at_head_dim(d):
    """The serving kernels' tile rows: the real columns are whole 16-byte
    chunks (int8 16 values, bf16 8, f32 4) and whole lane shares of the
    CUDA-core layout (tile / 32 columns a lane).  The training kernels'
    blocks of a head write the real columns once, in whole chunks.  Every
    plan the serving shapes give (decode and chunks, G 1 to 8, float and
    int8, bf16 and f32): shared memory as the kernel lays it out on the
    tile's rows and within a block's limit, the rows a block within the
    kernel's, and the split's tile ranges cover [0, kv_len) once."""
    t = fd.tile_dim(d)
    for elsize in (1, 2, 4):
        vec = 16 // elsize
        assert d % vec == 0 and d // vec <= t // vec
    vpl = t // 32
    assert d % vpl == 0 and d // vpl <= 32
    assert fd.simt_max_rows(d) == (8 if t > 128 else 16)
    cols = fa.column_blocks(d)
    assert len(cols) == (2 if t > 128 else 1)
    covered = np.zeros(t, int)
    for lo, hi in cols:
        assert lo < hi and (hi - lo) % 8 == 0 and hi - lo <= t // len(cols)
        covered[lo:hi] += 1
    assert (covered[:d] == 1).all() and (covered[d:] == 0).all()
    for b, hkv, r, s in ((4, 8, 2, 576), (4, 8, 8, 1600), (1, 8, 128, 576),
                         (4, 2, 64, 2048), (1, 4, 512, 576)):
        for dtype in (torch.bfloat16, torch.float32):
            for int8 in (False, True):
                p = fd._plan(b, hkv, r, s, dtype, int8, d)
                kvb = 1 if int8 else (2 if dtype == torch.bfloat16 else 4)
                assert p.smem == fd._smem(p.kernel, p.rows, t, kvb, int8)
                assert p.smem <= SMEM_MAX, (d, b, hkv, r, s, dtype, p)
                if p.kernel == "simt":
                    assert p.rows in (2, 4, fd.simt_max_rows(d))
                else:
                    assert dtype == torch.bfloat16 and p.rows in (16, 32, 64)
                for kv_len in (0, 1, p.bk - 1, s // 2 + 3, s):
                    ranges = fd._tile_ranges(p, kv_len, s)
                    seen = [i for lo, hi in ranges
                            for i in range(lo * p.bk, hi * p.bk)]
                    n = -(-kv_len // p.bk) * p.bk
                    assert seen == list(range(n))


def _paged_case(rng, b, n_tbl, nb, bs, hkv, d, fills, int8):
    """Scrambled pool blocks, poisoned (valid-looking) entries outside the
    live regions, as ``tests/test_torch_paged_attention.py`` builds them."""
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
        scales = tuple((rng.uniform(0.5, 2.0, (nb, bs, hkv)) / 127.0)
                       .astype(np.float32) for _ in range(2))
    return k, v, scales, pos, table, np.asarray(fills, np.int32)


def _caches(k, v, scales):
    if scales[0] is None:
        return (jnp.asarray(k), jnp.asarray(v),
                torch.from_numpy(k), torch.from_numpy(v))
    ks, vs = scales
    return (JInt8KV(jnp.asarray(k), jnp.asarray(ks)),
            JInt8KV(jnp.asarray(v), jnp.asarray(vs)),
            tq.Int8KV(torch.from_numpy(k), torch.from_numpy(ks)),
            tq.Int8KV(torch.from_numpy(v), torch.from_numpy(vs)))


@pytest.mark.parametrize("fn_name", ["decode_attention", "chunk_attention"])
@pytest.mark.parametrize("d", [16, 32, 96])
def test_serving_plain_matches_jax(fn_name, d):
    """The contiguous float cache and the paged int8 pool (blocks of 8),
    G 2, an idle slot and pad query rows: the plain version against the
    JAX Pallas kernel in interpret mode (``tests/test_torch_paged_attention.py``
    holds the other layouts and the ref path at D 16)."""
    rng = np.random.RandomState(d)
    b, hkv, g, bs, n_tbl = 3, 2, 2, 8, 4
    c = 1 if fn_name == "decode_attention" else 4
    fills = [13, 0, 32]
    for paged, int8 in ((False, False), (True, True)):
        k, v, scales, pos, table, kvl = _paged_case(
            rng, b, n_tbl, 14, bs, hkv, d, fills, int8)
        if not paged:   # each slot's logical cache made contiguous
            gather = table.reshape(-1)
            k, v, pos = (x[gather].reshape((b, n_tbl * bs) + x.shape[2:])
                         for x in (k, v, pos))
            if int8:
                scales = tuple(x[gather].reshape(b, n_tbl * bs, hkv)
                               for x in scales)
            pos = np.where(np.arange(n_tbl * bs)[None] < kvl[:, None],
                           pos, -1).astype(np.int32)
            table = None
        q = rng.randn(b, c, hkv * g, d).astype(np.float32)
        if c == 1:
            qp = np.maximum(kvl - 1, 0).astype(np.int32)
        else:   # slot 2's last row is a pad row
            qp = np.full((b, c), -1, np.int32)
            for i, (f, r) in enumerate(zip(kvl, (c, 0, c - 1))):
                qp[i, :r] = np.arange(f - r, f)
        jk, jv, tk, tv = _caches(k, v, scales)
        t_tab = None if table is None else torch.from_numpy(table)
        j_tab = None if table is None else jnp.asarray(table)
        port = getattr(tops, fn_name)(
            torch.from_numpy(q), tk, tv, torch.from_numpy(qp),
            torch.from_numpy(pos), kv_len=torch.from_numpy(kvl),
            block_table=t_tab).numpy()
        assert port.shape == q.shape
        want = np.asarray(getattr(jops, fn_name)(
            jnp.asarray(q), jk, jv, jnp.asarray(qp), jnp.asarray(pos),
            kv_len=jnp.asarray(kvl), block_table=j_tab,
            force="interpret"))
        np.testing.assert_allclose(port, want, atol=ATOL)
        assert np.all(port[1] == 0)   # the idle slot: exact zeros


@pytest.mark.parametrize("d", [16, 32, 96])
def test_flash_attention_plain_matches_jax(d):
    """The forward (causal GQA; a window without causality) against the JAX
    Pallas kernel
    in interpret mode (tiles of 64) and its ref; the plain backward
    against ``jax.grad`` of the JAX reference."""
    rng = np.random.RandomState(100 + d)
    b, s, hq, hkv = 1, 128, 4, 2
    q, do = (rng.randn(b, s, hq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))

    def expand(x):
        return jnp.repeat(jnp.asarray(x), hq // x.shape[2], axis=2)

    def fold(x):
        return expand(x).transpose(0, 2, 1, 3).reshape(b * hq, s, d)

    for causal, window in ((True, 0), (False, 48)):
        got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window).numpy()
        interp = jfa_kernel(fold(q), fold(k), fold(v), causal=causal,
                            window=window, block_q=64, block_k=64,
                            interpret=True)
        interp = np.asarray(interp.reshape(b, hq, s, d)
                            .transpose(0, 2, 1, 3))
        ref = np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), expand(k), expand(v), causal=causal,
            window=window))
        np.testing.assert_allclose(got, interp, atol=ATOL)
        np.testing.assert_allclose(got, ref, atol=ATOL)

    def loss(q_, k_, v_):
        out = jref.flash_attention_ref(
            q_, jnp.repeat(k_, hq // hkv, axis=2),
            jnp.repeat(v_, hq // hkv, axis=2), causal=True, window=0)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = tref.flash_attention_ref(*t, True, 0)
    got = tref.flash_attention_bwd_ref(*t, out, torch.from_numpy(do), True,
                                       0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
