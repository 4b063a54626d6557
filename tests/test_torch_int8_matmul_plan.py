"""The int8 matmul's launch plan (``kernels/int8_matmul.py::_plan``),
held on the CPU to what the CUDA kernel needs of it: the split's K ranges
cover [0, K) once with none empty, a cluster holds at most 8 blocks,
shared memory stays within a block's 227 KB, the serving shapes fill the
H100's 132 SMs, and the regime follows M alone.  No JAX."""
import itertools

import pytest

from repro_torch.kernels import int8_matmul as im

SMEM_MAX = 232_448       # bytes of shared memory a block may take (H100)
# (M, K, N) of the int8 serving path: q/o, k/v, gate/up, down at the
# decode step's 4 slots and the chunk's 64 tokens; then the MoE decoders'
# attention projections (their experts stay float), each K and N once at
# either M: phi3.5-moe's k/v and q/o (K 4,096), dbrx's (K 6,144)
SERVING = [(m, k, n) for m in (4, 64)
           for k, n in ((2048, 2048), (2048, 1024), (2048, 8192),
                        (8192, 2048))] + [
    (4, 4096, 1024), (64, 4096, 4096), (4, 6144, 1024), (64, 6144, 6144)]
SWEEP = list(itertools.product((1, 4, 8, 16, 17, 63, 64, 65, 128, 300),
                               (1, 7, 31, 128, 129, 200, 1040, 2048, 8192),
                               (1, 65, 300, 1024, 8192)))


def _ranges(p, k):
    return [(r * p.kchunk, min(k, (r + 1) * p.kchunk))
            for r in range(p.split)]


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 7, 300), (64, 31, 65),
                                   (5, 200, 300), (4, 129, 1024),
                                   (64, 1040, 65), (4, 8192, 2048),
                                   (300, 100_000, 64)])
def test_k_split_covers_k_once_with_no_empty_range(m, k, n):
    """Block r of the split sums K bytes [r * kchunk, min(K, (r + 1) *
    kchunk)): the ranges tile [0, K) in order, each holds at least one
    byte, and each is whole K tiles (its end is a tile boundary or K)."""
    p = im._plan(m, n, k)
    ranges = _ranges(p, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    assert p.kchunk % im.BK == 0
    assert p.grid[0] == p.split


def test_cluster_shared_memory_and_tiles_within_the_kernels_limits():
    """Over a sweep of ragged and serving shapes: at most 8 blocks a
    cluster, shared memory within 227 KB and equal to the ring's bytes
    and the alignment slack, a tile the kernel is built for."""
    for m, k, n in SWEEP:
        p = im._plan(m, n, k)
        assert 1 <= p.split <= im.MAX_SPLIT == 8, (m, k, n)
        assert p.smem == im.STAGES * (p.bn + p.mt) * im.BK + im.SMEM_SLACK
        assert p.smem <= SMEM_MAX, (m, k, n)
        assert p.mt in (8, 16, 64) and p.bn == im.BN == 32, (m, k, n)


def test_no_block_with_an_empty_k_range_over_the_sweep():
    """The kernel refuses a split whose last block would start at or past
    K: the plan never makes one, whatever the shape."""
    for m, k, n in SWEEP:
        p = im._plan(m, n, k)
        assert (p.split - 1) * p.kchunk < k <= p.split * p.kchunk, (m, k, n)


@pytest.mark.parametrize("m,k,n", SERVING)
def test_serving_shapes_fill_the_card(m, k, n):
    """At least one block an SM at every serving shape, so that every SM
    streams its share of the weight."""
    p = im._plan(m, n, k)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert blocks >= im.SMS == 132, p


# seamless-m4t-large-v2's projections (d 1,024, d_ff 8,192) at the decode
# step's 4 slots and a chunk of 64: q/k/v/o and the cross K/V (K 1,024 ->
# N 1,024), gate/up (-> N 8,192), down (K 8,192 -> N 1,024); and the cross
# K/V of the whole encoder output (B 4 x S_enc 512 = M 2,048)
ENCDEC = [(m, k, n) for m in (4, 64)
          for k, n in ((1024, 1024), (1024, 8192), (8192, 1024))] + [
    (2048, 1024, 1024)]


def test_encdec_shapes_fill_the_card():
    """The enc-dec backbone's shapes fill the card too, in one wave: K
    1,024 into N 1,024 splits its 8 K tiles over 8 blocks (256), not 4
    blocks of 2 (128, four SMs idle)."""
    for m, k, n in ENCDEC:
        p = im._plan(m, n, k)
        blocks = p.grid[0] * p.grid[1] * p.grid[2]
        assert blocks >= im.SMS, (m, k, n, p)
        assert p.split == 1 or blocks < 3 * im.SMS, (m, k, n, p)
        assert (p.split - 1) * p.kchunk < k <= p.split * p.kchunk
    assert im._plan(4, 1024, 1024).split == 8


def test_regime_follows_m_alone():
    """Decode (8 or 16 tokens a tile) for M <= 16, the tensor-core chunk
    tile of 64 tokens above, whatever K and N are."""
    for m, k, n in SWEEP:
        p = im._plan(m, n, k)
        if m <= 16:
            assert p.regime == "decode" and p.mt == (8 if m <= 8 else 16)
        else:
            assert p.regime == "chunk" and p.mt == 64


def test_grid_tiles_the_output_with_no_empty_tile():
    """(N tiles, M tiles) cover the (M, N) output, and the last tile of
    each axis holds at least one row or channel."""
    for m, k, n in SWEEP:
        p = im._plan(m, n, k)
        assert (p.grid[1] - 1) * p.bn < n <= p.grid[1] * p.bn
        assert (p.grid[2] - 1) * p.mt < m <= p.grid[2] * p.mt


def test_plan_is_the_same_for_the_same_shape():
    """The plan is a function of (m, n, k): cached, and equal when asked
    again."""
    assert im._plan(4, 8192, 2048) is im._plan(4, 8192, 2048)
    assert im._plan(64, 2048, 8192) == im._plan(64, 2048, 8192)
