"""The serving attention kernels' launch plan and arithmetic, rehearsed on
the CPU.  No JAX.

``kernels/flash_decode.py::_plan`` fixes each launch from the shape
alone; the kernels in ``csrc/flash_decode.cu`` split every slot's KV
sweep over the blocks of a cluster, block ``rank`` taking the whole tiles
``_tile_ranges`` names, and merge the blocks' partial softmax states.
Here the plan is held to what the kernels need of it (the ranges cover
[0, kv_len) once in whole tiles, every block of a split takes part, the
cluster divides the grid, shared memory fits, the serving shapes fill the
H100's 132 SMs), and the arithmetic is emulated in plain torch against
``ref.chunk_attention_ref`` at the limits ``chip_smoke.py`` holds the card
to (bf16: the output's own rounding, 2^-8 of each value, plus 1e-5; f32:
1e-5):

- the split: each block's online softmax in base 2 over its tiles (m from
  -1e30, a masked score -inf), then m = max m_i, l = sum l_i 2^(m_i - m),
  acc likewise, out = acc / max(l, 1e-30); empty blocks and an idle slot
  give exact zeros;
- the tensor-core chunk kernel: bf16 q and K in an f32 product, the
  softmax scale on the f32 scores, P split into bf16 hi + mid + lo
  against V.  One rounding of P fails the limit, as for the training
  kernels (``tests/test_torch_flash_attention_numerics.py``); hi + lo
  passes it but flips about four times as many bf16 outputs as f32 P,
  enough for ``chip_smoke.py``'s int8 greedy gate (phase 5) to fail.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

SMEM_MAX = 232_448                 # bytes of shared memory a block may take
OUT_RTOL, OUT_ATOL = 2.0 ** -8, 1e-5          # chip_smoke.TOL[bf16]
F32_ATOL = 1e-5                               # chip_smoke.TOL[f32]
# serving shapes of internlm2-1.8b at capacity 576: decode (4 slots x 8 KV
# heads x G 2) and a chunk (1 slot x 8 KV heads x 64 queries x G 2)
SERVING = {"decode": (4, 8, 2, 576), "chunk": (1, 8, 128, 576)}


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(SERVING))
@pytest.mark.parametrize("s,bs", [(576, 8), (576, 64), (555, None)])
def test_tile_ranges_cover_kv_len_once(kind, s, bs):
    """For every kv_len in 0..S: split ranges, one a block (possibly
    empty), in order, of whole tiles, covering the live tiles once; the
    entries they load (index < kv_len) name only live table entries."""
    b, hkv, r, _ = SERVING[kind]
    for dtype in (torch.bfloat16, torch.float32):
        plan = fd._plan(b, hkv, r, s, dtype, False, 128)
        for kvl in range(s + 1):
            ranges = fd._tile_ranges(plan, kvl, s)
            assert len(ranges) == plan.split
            assert ranges[0][0] == 0 and ranges[-1][1] == _cdiv(kvl, plan.bk)
            assert all(lo <= hi for lo, hi in ranges)
            assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
            live = [i for lo, hi in ranges
                    for i in range(lo * plan.bk, min(hi * plan.bk, kvl))]
            assert live == list(range(kvl))
            if bs is not None:
                assert max((i // bs for i in live), default=-1) \
                    < _cdiv(kvl, bs)


def test_ranges_clamp_kv_len_and_balance():
    """kv_len outside [0, S] is clamped as the kernel clamps it, and the
    blocks' tile counts differ by at most one."""
    plan = fd._plan(*SERVING["decode"], torch.bfloat16, False, 128)
    assert fd._tile_ranges(plan, -5, 576) == [(0, 0)] * plan.split
    assert fd._tile_ranges(plan, 10 ** 6, 576) \
        == fd._tile_ranges(plan, 576, 576)
    for kvl in range(577):
        n = [hi - lo for lo, hi in fd._tile_ranges(plan, kvl, 576)]
        assert max(n) - min(n) <= 1


def test_plan_limits_over_a_sweep():
    """Split 1, 2, 4 or 8 (the portable cluster size), dividing the grid's
    z; z is the row tiles times the split; shared memory within a block's
    227 KB and what the kernel lays out; the kernel and row tile the
    kernels are built for."""
    for b in (1, 2, 4, 17, 64):
        for hkv in (1, 2, 8):
            for r in (1, 2, 3, 16, 17, 32, 128, 300):
                for s in (8, 32, 64, 555, 576, 4096):
                    for dtype in (torch.bfloat16, torch.float32):
                        for int8 in (False, True):
                            for d in (64, 128):
                                p = fd._plan(b, hkv, r, s, dtype, int8, d)
                                assert p.split in (1, 2, 4, 8)
                                assert p.grid[2] % p.split == 0
                                assert p.grid == (b, hkv, _cdiv(r, p.rows)
                                                  * p.split)
                                assert p.smem <= SMEM_MAX
                                kvb = 1 if int8 else (2 if dtype
                                                      == torch.bfloat16
                                                      else 4)
                                assert p.smem == fd._smem(p.kernel, p.rows,
                                                          d, kvb, int8)
                                if p.kernel == "mma":
                                    assert dtype == torch.bfloat16
                                    assert p.rows in (16, 32, 64)
                                    assert (p.bk, p.stages) == (
                                        fd.MMA_BK, fd.MMA_STAGES)
                                else:
                                    assert p.rows in (2, 4, 16)
                                    assert (p.bk, p.stages) == (
                                        fd.SIMT_BK, fd.SIMT_STAGES)


@pytest.mark.parametrize("kind", list(SERVING))
@pytest.mark.parametrize("int8", [False, True])
def test_serving_shapes_fill_the_card(kind, int8):
    """At least one block an SM at the serving shapes (decode: 32 blocks
    without the split), decode on the CUDA cores, the chunk on the tensor
    cores."""
    b, hkv, r, s = SERVING[kind]
    p = fd._plan(b, hkv, r, s, torch.bfloat16, int8, 128)
    assert p.grid[0] * p.grid[1] * p.grid[2] >= fd.SMS == 132
    assert p.kernel == ("simt" if kind == "decode" else "mma")


# seamless-m4t-large-v2 (16/16 heads of 64, G 1): the decode step and a
# chunk of 16 at 4 slots, against its self cache (capacity 128) and the
# cross cache (the encoder's 512 entries)
ENCDEC = {"decode": (4, 16, 1, 128), "chunk": (4, 16, 16, 128),
          "cross_decode": (4, 16, 1, 512), "cross_chunk": (4, 16, 16, 512)}


def test_d64_g1_shapes_fill_the_card():
    """At D 64 and G 1 every serving call of the enc-dec decoder fills the
    card in one launch, on the CUDA cores (16 rows or fewer a KV head),
    float and int8, and its tile ranges cover the cache once."""
    for name, (b, hkv, r, s) in ENCDEC.items():
        for int8 in (False, True):
            p = fd._plan(b, hkv, r, s, torch.bfloat16, int8, 64)
            assert p.grid[0] * p.grid[1] * p.grid[2] >= fd.SMS, (name, p)
            assert p.kernel == "simt", (name, p)
            tiles = [t for lo, hi in fd._tile_ranges(p, s, s)
                     for t in range(lo, hi)]
            assert tiles == list(range(_cdiv(s, p.bk))), name


def test_kernel_and_rows_follow_dtype_and_rows():
    """bf16 calls of more than 16 rows take the tensor cores; f32 calls and
    up to 16 rows the CUDA cores, 2 rows a block for up to 2 rows, 4 for
    3 and 4."""
    p = fd._plan
    assert p(4, 8, 2, 576, torch.float32, False).kernel == "simt"
    assert p(4, 8, 2, 576, torch.bfloat16, True).rows == 2
    assert p(4, 8, 4, 576, torch.bfloat16, False).rows == 4
    assert p(4, 8, 5, 576, torch.bfloat16, False).rows == 16
    assert p(1, 8, 16, 576, torch.bfloat16, False).kernel == "simt"
    assert p(1, 8, 17, 576, torch.bfloat16, False).kernel == "mma"
    assert p(1, 8, 128, 576, torch.float32, False).kernel == "simt"


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------
def _case(b, c, s, hkv, g, d, fills, reals, dtype, seed=0):
    """Numpy-seeded inputs in the ops layout: q (B, C, Hq, D) of dtype, K/V
    (B, S, Hkv, D) of dtype (NaN past each slot's fill, which the kernels
    never read), positions 0.. up to each fill, the real queries at the
    last of them, pad queries -1."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, c, hkv * g, d).astype(np.float32)) \
        .to(dtype)
    k, v = (torch.from_numpy(rng.randn(b, s, hkv, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    pos = torch.full((b, s), -1, dtype=torch.int32)
    qpos = torch.full((b, c), -1, dtype=torch.int32)
    for i, (n, r) in enumerate(zip(fills, reals)):
        pos[i, :n] = torch.arange(n)
        qpos[i, :r] = torch.arange(n - r, n)
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    return q, k, v, qpos, pos, torch.tensor(fills, dtype=torch.int32)


def _split_p(p, parts):
    """P as the tensor cores take it, back in f32: ``parts`` bf16 values,
    each the rounding of what the ones before leave (hi, mid, lo)."""
    out = torch.zeros_like(p)
    for _ in range(parts):
        out = out + (p - out).to(torch.bfloat16).float()
    return out


def emulate(q, k, v, qpos, pos, kvl, plan, s, mma=False, parts=3):
    """The kernels' arithmetic in the ops layout: for each slot the split's
    blocks sweep their tile ranges with an online softmax in base 2 (f32
    scores times softmax scale x log2 e, masked -inf, m from -1e30), then
    merge; ``mma`` feeds P V with P as ``parts`` bf16 parts (the kernel's
    three: hi + mid + lo)."""
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale_log2 = torch.tensor(1.4426950408889634 / math.sqrt(d),
                              dtype=torch.float32)
    qf = q.float().reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, c * g, d)
    qp = qpos[:, :, None].expand(b, c, g).reshape(b, c * g)
    out = torch.zeros(b, hkv, c * g, d)
    for bi in range(b):
        kv = min(max(int(kvl[bi]), 0), s)
        blocks = []
        for lo_t, hi_t in fd._tile_ranges(plan, kv, s):
            m = torch.full((hkv, c * g), -1e30)
            l = torch.zeros(hkv, c * g)
            acc = torch.zeros(hkv, c * g, d)
            for t in range(lo_t, hi_t):
                idx = torch.arange(t * plan.bk, min((t + 1) * plan.bk, s))
                live = idx < kv
                kt = torch.where(live[:, None, None], k[bi, idx].float(), 0.)
                vt = torch.where(live[:, None, None], v[bi, idx].float(), 0.)
                sc = (qf[bi] @ kt.permute(1, 2, 0)) * scale_log2
                ps = pos[bi, idx]
                vis = live[None] & (ps[None] >= 0) & (ps[None] <= qp[bi, :,
                                                                     None])
                sc = torch.where(vis[None], sc, -torch.inf)
                mx = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(sc - mx[..., None])
                l = l * alpha + p.sum(-1)
                pv = _split_p(p, parts) if mma else p
                acc = acc * alpha[..., None] + pv @ vt.permute(1, 0, 2)
                m = mx
            blocks.append((m, l, acc))
        ms = torch.stack([x[0] for x in blocks])
        mx = ms.amax(0)
        w = torch.exp2(ms - mx)
        lsum = (torch.stack([x[1] for x in blocks]) * w).sum(0)
        asum = (torch.stack([x[2] for x in blocks]) * w[..., None]).sum(0)
        out[bi] = asum / lsum.clamp(min=1e-30)[..., None]
    out = out.to(q.dtype)
    return out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, hq, d)


def _want(q, k, v, qpos, pos, kvl):
    return tref.chunk_attention_ref(q.float(), k.float(), v.float(), qpos,
                                    pos, kv_len=kvl)


def _reading(out, want):
    """Largest |out - want| in units of the limit of ``out``'s dtype."""
    rtol, atol = (OUT_RTOL, OUT_ATOL) if out.dtype == torch.bfloat16 \
        else (0.0, F32_ATOL)
    return float(((out.float() - want).abs()
                  / (rtol * want.abs() + atol)).max())


def _forced(plan, split):
    return fd.Plan(plan.kernel, plan.rows, plan.bk, plan.stages, split,
                   plan.grid[:2] + (plan.grid[2] // plan.split * split,),
                   plan.smem)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_decode_merge_within_limit(split):
    """Decode at S 576, slots at kv_len 0, 1, 37, 576 (G 2, D 128), bf16
    and f32: the split's merge against the plain version; the idle slot
    is exactly zero."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, qpos, pos, kvl = _case(4, 1, 576, 2, 2, 128,
                                        [0, 1, 37, 576], [0, 1, 1, 1], dtype)
        plan = _forced(fd._plan(4, 2, 2, 576, dtype, False, 128), split)
        out = emulate(q, k, v, qpos, pos, kvl, plan, 576)
        assert bool(out.isfinite().all())
        assert _reading(out, _want(q, k, v, qpos, pos, kvl)) <= 1
        assert bool((out[0] == 0).all())


@pytest.mark.parametrize("split", [2, 8])
def test_split_chunk_merge_within_limit(split):
    """A chunk of 16 queries (f32 on the CUDA cores) over S 555 at kv_len
    0 (all pad), 300 and 555: the merge within 1e-5, pad rows zero."""
    q, k, v, qpos, pos, kvl = _case(3, 16, 555, 2, 2, 64, [0, 300, 555],
                                    [0, 16, 9], torch.float32, seed=1)
    plan = _forced(fd._plan(3, 2, 32, 555, torch.float32, False, 64), split)
    out = emulate(q, k, v, qpos, pos, kvl, plan, 555)
    assert _reading(out, _want(q, k, v, qpos, pos, kvl)) <= 1
    assert bool((out[0] == 0).all()) and bool((out[2, 9:] == 0).all())


def test_empty_blocks_take_part_with_zero_weight():
    """kv_len 1 at split 8: seven of eight blocks are empty (m -1e30, l 0,
    acc 0); the merge weighs them exactly 0 and gives the one live entry's
    V row itself, in f32."""
    q, k, v, qpos, pos, kvl = _case(1, 1, 576, 2, 2, 128, [1], [1],
                                    torch.float32, seed=2)
    plan = fd._plan(1, 2, 2, 576, torch.float32, False, 128)
    assert plan.split == 8
    ranges = fd._tile_ranges(plan, 1, 576)
    assert sum(hi > lo for lo, hi in ranges) == 1
    out = emulate(q, k, v, qpos, pos, kvl, plan, 576)
    want = v[0, 0].float()[:, None, :].expand(2, 2, 128).reshape(1, 1, 4,
                                                                 128)
    assert torch.equal(out, want)


@pytest.mark.parametrize("split", [1, 8])
def test_mma_chunk_arithmetic_within_limit(split):
    """The tensor-core chunk kernel's arithmetic at the serving chunk (64
    queries x G 2, D 128, 448 live entries, 20 pad queries): f32 scores,
    the scale on the f32 sum, P hi + mid + lo; pad rows exactly zero."""
    q, k, v, qpos, pos, kvl = _case(1, 64, 576, 2, 2, 128, [448], [44],
                                    torch.bfloat16, seed=3)
    plan = _forced(fd._plan(1, 2, 128, 576, torch.bfloat16, False, 128),
                   split)
    assert plan.kernel == "mma"
    out = emulate(q, k, v, qpos, pos, kvl, plan, 576, mma=True)
    assert _reading(out, _want(q, k, v, qpos, pos, kvl)) <= 1
    assert bool((out[0, 44:] == 0).all())


def test_p_rounded_once_fails_the_chunk_limit():
    """Why the chunk kernel splits P: rounded once to bf16 before P V, the
    output leaves the limit; split, it stays inside."""
    q, k, v, qpos, pos, kvl = _case(1, 64, 576, 2, 2, 128, [448], [64],
                                    torch.bfloat16, seed=4)
    plan = fd._plan(1, 2, 128, 576, torch.bfloat16, False, 128)
    want = _want(q, k, v, qpos, pos, kvl)
    once = emulate(q, k, v, qpos, pos, kvl, plan, 576, mma=True, parts=1)
    split = emulate(q, k, v, qpos, pos, kvl, plan, 576, mma=True)
    assert _reading(once, want) > 1
    assert _reading(split, want) <= 1


def test_p_in_three_parts_flips_no_more_outputs_than_f32_p():
    """Why three parts, not two: against the plain version rounded once to
    bf16, P as hi + lo (16 bits) changes at least twice as many bf16
    outputs as P in f32 does; hi + mid + lo (24 bits) no more than f32 P
    (8 KV heads, the serving chunk)."""
    q, k, v, qpos, pos, kvl = _case(1, 64, 576, 8, 2, 128, [448], [64],
                                    torch.bfloat16, seed=5)
    plan = fd._plan(1, 8, 128, 576, torch.bfloat16, False, 128)
    want = _want(q, k, v, qpos, pos, kvl).to(torch.bfloat16)

    def flips(**kw):
        out = emulate(q, k, v, qpos, pos, kvl, plan, 576, **kw)
        return int((out != want).sum())

    f32 = flips()
    assert flips(mma=True, parts=3) <= f32
    assert flips(mma=True, parts=2) >= 2 * max(f32, 1)
