"""The int8 matmul kernel on the card, bitwise against its plain version
(``ref.int8_matmul_ref``, an exact float64 sum there), one launch a call:
every regime boundary of M, K shorter than a K tile and than the split,
N off the channel tile, rows that are not 16-byte aligned, and the
largest |sum|.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_int8_matmul_cuda.py

This file imports neither JAX nor the JAX package.
"""
import pytest
import torch

from repro_torch.kernels import int8_matmul as tim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _operands(dev, m, k, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=dev) * 0.1 + 1e-3
    ws = torch.rand(n, generator=gen, device=dev) * 0.1 + 1e-3
    return x, w, xs, ws


def _bitwise_one_launch(x, w, xs, ws):
    before = tim.LAUNCHES["int8_matmul"]
    out = tops.int8_matmul(x, w, xs, ws)
    assert tim.LAUNCHES["int8_matmul"] == before + 1
    torch.cuda.synchronize()
    want = tref.int8_matmul_ref(x, w, xs, ws)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert torch.equal(out, want), float((out - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 63, 64, 65, 128])
def test_regime_boundaries_of_m(cuda_device, m):
    """Decode tiles of 8 and 16 tokens, the chunk tile of 64, and two M
    tiles, at a K/V projection's shape (K 2048, N 1024)."""
    _bitwise_one_launch(*_operands(cuda_device, m, 2048, 1024, m))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 31, 200])
@pytest.mark.parametrize("m", [4, 64])
def test_k_below_a_tile_and_below_the_split(cuda_device, m, k):
    """K shorter than one 128-byte K tile (7, 31: no split, byte loads)
    and than the split's wish (200: two tiles), in both regimes."""
    _bitwise_one_launch(*_operands(cuda_device, m, k, 300, 100 + k + m))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4, 65), (64, 300)])
def test_n_off_the_channel_tile(cuda_device, m, n):
    """A last channel tile with 1 or 12 channels of 32."""
    _bitwise_one_launch(*_operands(cuda_device, m, 1040, n, 200 + n))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_rows_not_16_byte_aligned(cuda_device, m):
    """x and w as column slices of wider tensors: rows 1 and 3 bytes off
    a 16-byte boundary, strides 2,061 and 2,067 (the byte-load path)."""
    k, n = 2048, 1024
    x, w, xs, ws = _operands(cuda_device, m, k + 13, n, 300 + m)
    w = torch.cat([w, w[:, :6]], dim=1)
    xv, wv = x[:, 1:1 + k], w[:, 3:3 + k]
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16 and xv.stride(0) % 16
    _bitwise_one_launch(xv, wv, xs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_largest_sum(cuda_device, m):
    """All +127 against all -127 at K 8192: every sum is -132,128,768,
    split over a cluster and rounded once to f32."""
    k, n = 8192, 2048
    x = torch.full((m, k), 127, dtype=torch.int8, device=cuda_device)
    w = torch.full((n, k), -127, dtype=torch.int8, device=cuda_device)
    xs = torch.full((m,), 0.5, device=cuda_device)
    ws = torch.linspace(1e-3, 1.0, n, device=cuda_device)
    _bitwise_one_launch(x, w, xs, ws)
    out = tops.int8_matmul(x, w, xs, torch.ones(n, device=cuda_device))
    assert torch.equal(out, torch.full_like(out, -127 * 127 * k * 0.5))
