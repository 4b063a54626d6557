"""The serving attention kernels' launch plan at head dim 80, rehearsed on
the CPU.  No JAX.

zamba2-2.7b's shared attention block has 32 query heads on 32 KV heads of
80 (G 1): a decode step has one query row a KV head, a chunk of 64 has
64, over a cache of 576 entries (serving: max_prompt 512 + 32 new
tokens) or of 2,080 (a one-shot prefill of 2,048 grown by 32).  The
kernels compute D 80 on tiles of 128 (``csrc/flash_decode.cu``: the
columns past 80 zero-filled in shared memory, never written out), so
``kernels/flash_decode.py::_plan`` and ``_smem`` must lay out D 128's
tiles and merge buffers while the bytes read stay D 80's: the row tiles
cover the rows once, the KV tile ranges cover [0, kv_len) once for every
kv_len, the split (a cluster of at most 8) divides the grid, and the
shared memory fits a block's 232,448 bytes.
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd

SMEM_MAX = 232_448
# name: (slots, Hkv, rows a KV head, capacity)
SHAPES = {
    "decode": (4, 32, 1, 576),
    "chunk": (1, 32, 64, 576),
    "ragged_chunk": (1, 32, 64, 555),
    "prefill_then_decode": (1, 32, 1, 2080),
}
D = 80


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plan_covers_rows_and_tiles_once(name, dtype):
    """Float and int8 K/V: row tiles cover the R rows once; every
    kv_len's tiles are dealt to the split's blocks once, in order, in
    whole tiles; grid, split and shared memory as the kernels take them,
    the shared memory that of the tile width 128."""
    b, hkv, r, s = SHAPES[name]
    for int8 in (False, True):
        p = fd._plan(b, hkv, r, s, dtype, int8, D)
        tiles = p.grid[2] // p.split
        assert p.grid == (b, hkv, tiles * p.split)
        assert p.split in (1, 2, 4, 8)
        assert (tiles - 1) * p.rows < r <= tiles * p.rows
        kvb = 1 if int8 else dtype.itemsize
        assert p.smem == fd._smem(p.kernel, p.rows, 128, kvb, int8) \
            == fd._smem(p.kernel, p.rows, D, kvb, int8) <= SMEM_MAX
        assert p == fd._plan(b, hkv, r, s, dtype, int8, 128)
        for kv_len in range(0, s + 1, 7):
            ranges = fd._tile_ranges(p, kv_len, s)
            assert len(ranges) == p.split
            assert ranges[0][0] == 0
            assert ranges[-1][1] == _cdiv(kv_len, p.bk)
            for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
                assert b0 <= e0 == b1


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_rows_and_occupancy(name):
    """bf16 chunks of 64 rows on the tensor cores (64 rows a block, one
    block a KV head), decode and f32 on the CUDA cores (2 rows a block at
    G 1, 16 for f32 chunks); the grid holds a block an SM or takes the
    largest split the cache allows."""
    b, hkv, r, s = SHAPES[name]
    p = fd._plan(b, hkv, r, s, torch.bfloat16, False, D)
    assert p.kernel == ("mma" if r > fd.SIMT_MAX_ROWS else "simt")
    if p.kernel == "simt":
        assert p.rows == 2
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    max_split = min(fd.MAX_SPLIT, 2 ** (_cdiv(s, p.bk).bit_length() - 1))
    assert blocks >= fd.SMS or p.split == max_split
    f32 = fd._plan(b, hkv, r, s, torch.float32, False, D)
    assert f32.kernel == "simt"
    assert f32.rows == (2 if r == 1 else 16)
    assert f32.smem <= SMEM_MAX


def test_tile_width_and_merge_buffers():
    """D 80 computes on tiles of 128 (the other head dims on their own),
    16 rows a CUDA-core block as at D 128; the merge buffers after the
    sweep hold rows x (128 + 2) f32, as the kernel lays them out."""
    assert [fd.tile_dim(d) for d in (64, 80, 128, 256)] == [64, 128, 128,
                                                           256]
    assert fd.simt_max_rows(80) == fd.simt_max_rows(128) == 16
    fd.check_head_dim(80)   # taken: a multiple of 16 up to 256
    for rows in (2, 16):
        merge = (fd._simt_warps(rows) + 1) * rows * (128 + 2) * 4
        assert fd._smem("simt", rows, D, 2, False) \
            == max(merge, fd.SIMT_STAGES * (2 * fd.SIMT_BK * 128 * 2
                                            + fd.SIMT_BK * 4)) \
            + fd.SMEM_SLACK
    ring = fd.MMA_STAGES * (2 * fd.MMA_BK * 128 + fd.MMA_BK * 4 * 3)
    deq = 2 * fd.MMA_BK * 128 * 2
    assert fd._smem("mma", 64, D, 1, True) == \
        max(ring + 64 * 128 * 2 + deq, 64 * 130 * 4) + fd.SMEM_SLACK
