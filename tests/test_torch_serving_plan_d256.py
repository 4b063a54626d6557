"""The serving attention kernels' launch plan at the shapes slices 7 and
8 add, rehearsed on the CPU.  No JAX.

gemma3-4b serves heads of D 256 at G 2 (8 query heads on 4 KV heads): a
decode step, a chunk of 64 against the global layers' cache, and a chunk
against the ring layout ``[ring ∥ chunk]`` of 1,024 + 64 entries.
llama3.2-3b (G 3) and granite-3-8b (G 4) serve D 128 with 24 and 32 query
heads on 8 KV heads: a decode step has 3 or 4 query rows a KV head, a
chunk of 64 has 192 or 256.  For each, ``kernels/flash_decode.py::_plan``
must give what ``csrc/flash_decode.cu`` is built for: the row tiles cover
the rows once, the KV tile ranges cover [0, kv_len) once for every
kv_len, the split (a cluster of at most 8) divides the grid, and the
shared memory fits a block's 232,448 bytes; the CUDA-core kernel takes at
most 8 rows a block at D 256 (16 rows of 8 columns a lane would hold 256
f32 of q and acc a thread).
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd

SMEM_MAX = 232_448
# name: (slots, Hkv, rows a KV head, capacity, D)
SHAPES = {
    "gemma3_decode": (4, 4, 2, 1600, 256),
    "gemma3_chunk": (1, 4, 128, 1600, 256),
    "gemma3_ring_chunk": (1, 4, 128, 1024 + 64, 256),
    "llama_decode": (4, 8, 3, 576, 128),
    "llama_chunk": (1, 8, 192, 576, 128),
    "granite_decode": (4, 8, 4, 576, 128),
    "granite_chunk": (1, 8, 256, 576, 128),
}


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plan_covers_rows_and_tiles_once(name, dtype):
    """Float and int8 K/V: row tiles cover the R rows once (the last one
    ragged at most); every kv_len's tiles are dealt to the split's blocks
    once, in order, in whole tiles; grid, split and shared memory as the
    kernels take them."""
    b, hkv, r, s, d = SHAPES[name]
    for int8 in (False, True):
        p = fd._plan(b, hkv, r, s, dtype, int8, d)
        tiles = p.grid[2] // p.split
        assert p.grid == (b, hkv, tiles * p.split)
        assert p.split in (1, 2, 4, 8)
        assert (tiles - 1) * p.rows < r <= tiles * p.rows
        kvb = 1 if int8 else dtype.itemsize
        assert p.smem == fd._smem(p.kernel, p.rows, d, kvb, int8) \
            <= SMEM_MAX
        for kv_len in range(0, s + 1, 7):
            ranges = fd._tile_ranges(p, kv_len, s)
            assert len(ranges) == p.split
            assert ranges[0][0] == 0
            assert ranges[-1][1] == _cdiv(kv_len, p.bk)
            for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
                assert b0 <= e0 == b1


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_rows_and_occupancy(name):
    """bf16 chunks on the tensor cores, decode and f32 on the CUDA cores
    (2 rows a block at G 2, 4 at G 3 and 4, else 16, or 8 at D 256); the
    grid holds a block an SM or takes the largest split the cache
    allows."""
    b, hkv, r, s, d = SHAPES[name]
    rows = next((n for n in (2, 4) if r <= n), fd.simt_max_rows(d))
    p = fd._plan(b, hkv, r, s, torch.bfloat16, False, d)
    assert p.kernel == ("mma" if r > fd.SIMT_MAX_ROWS else "simt")
    if p.kernel == "simt":
        assert p.rows == rows
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    max_split = min(fd.MAX_SPLIT, 2 ** (_cdiv(s, p.bk).bit_length() - 1))
    assert blocks >= fd.SMS or p.split == max_split
    f32 = fd._plan(b, hkv, r, s, torch.float32, False, d)
    assert f32.kernel == "simt"
    assert f32.rows == rows
    assert f32.smem <= SMEM_MAX


def test_d256_rows_a_block():
    """At D 256 the CUDA-core kernel takes 8 rows a block, at D 64 and 128
    16; decode at G <= 2 takes 2 everywhere, at G 3 and 4 4."""
    assert [fd.simt_max_rows(d) for d in (64, 128, 256)] == [16, 16, 8]
    assert fd._plan(1, 4, 16, 1088, torch.float32, False, 256).rows == 8
    assert fd._plan(4, 4, 2, 1088, torch.bfloat16, True, 256).rows == 2
    assert fd._plan(1, 8, 16, 576, torch.float32, False, 128).rows == 16
    assert fd._plan(4, 8, 3, 576, torch.bfloat16, False, 128).rows == 4
    assert fd._plan(4, 8, 4, 576, torch.float32, True, 256).rows == 4
