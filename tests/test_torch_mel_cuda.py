"""The mel-frontend CUDA kernel against its plain PyTorch version, on the
card, at the shapes the Impulse path gives it.  Skipped without a GPU
(marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_mel_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Tolerance: elementwise |kernel - plain| <= 1e-4 on
the log-mel, both in f32 (they sum in another order); silence exactly.
``chip_smoke.py`` repeats the check and times the kernel.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import keyword_audio
from repro_torch.dsp import blocks as tblocks
from repro_torch.kernels import mel_frontend as tmf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clips(n: int, n_samples: int, device) -> torch.Tensor:
    samples = keyword_audio(n_per_class=-(-n // 12), n_classes=12,
                            n_samples=n_samples, seed=0)
    return torch.from_numpy(np.stack([s.data for s in samples[:n]])) \
        .to(device)


def _check(frames, tables):
    before = tmf.LAUNCHES["mel_frontend"]
    out = tops.mel_frontend(frames, *tables)
    torch.cuda.synchronize()
    assert tmf.LAUNCHES["mel_frontend"] == before + 1
    want = tref.mel_frontend_ref(frames, *tables)
    assert out.shape == want.shape and out.dtype == torch.float32
    assert bool(out.isfinite().all())
    err = float((out - want).abs().max())
    assert err <= ATOL, err
    return out, want


@pytest.mark.cuda
@pytest.mark.parametrize("n_clips,n_samples,kw", [
    (512, 16_000, {}),                          # the full-width batch
    (64, 8000, {"n_mels": 32}),                 # the quickstart's MFCC
    (3, 16_000, {"frame_s": 0.04}),             # L 640 > n_fft 512
])
def test_unfold_view_matches_plain(cuda_device, n_clips, n_samples, kw):
    blk = tblocks.MFEBlock(**kw)
    sig = _clips(n_clips, n_samples, cuda_device)
    frames = tblocks.frame_signal(sig, blk.frame_len, blk.stride)
    assert frames.stride()[1] == blk.stride < blk.frame_len   # overlapping
    out, _ = _check(frames, blk.tables(cuda_device))
    assert out.shape == (n_clips,) + blk.feature_shape(n_samples)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 99, 50_689])
def test_ragged_frame_counts(cuda_device, f):
    blk = tblocks.MFEBlock()
    gen = torch.Generator(device=cuda_device).manual_seed(f)
    sig = torch.randn((f - 1) * blk.stride + blk.frame_len, generator=gen,
                      device=cuda_device) * 0.3
    frames = tblocks.frame_signal(sig, blk.frame_len, blk.stride)
    assert frames.shape == (f, blk.frame_len)
    _check(frames, blk.tables(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("f,l,nbins,n_mels", [(128, 256, 129, 40),
                                              (256, 512, 257, 32)])
def test_dense_frames_kernel_test_shapes(cuda_device, f, l, nbins, n_mels):
    rng = np.random.RandomState(3)
    kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / l
    arrays = (rng.randn(f, l), np.hanning(l), np.cos(kk), -np.sin(kk),
              rng.rand(nbins, n_mels))
    frames, *tables = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                       for a in arrays)
    _check(frames, tables)


@pytest.mark.cuda
def test_silence_is_exact(cuda_device):
    blk = tblocks.MFEBlock()
    out = blk(torch.zeros((4, 16_000), device=cuda_device))
    want = tref.mel_frontend_ref(
        tblocks.frame_signal(torch.zeros((4, 16_000), device=cuda_device),
                             blk.frame_len, blk.stride),
        *blk.tables(cuda_device))
    assert torch.equal(out, want)
    assert abs(float(out[0, 0, 0]) - math.log(1e-6)) < 1e-5
    assert bool((out == out[0, 0, 0]).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    blk = tblocks.MFEBlock()
    tables = blk.tables(cuda_device)
    frames = torch.randn(8, blk.frame_len, device=cuda_device)
    with pytest.raises(ValueError, match="unit stride"):
        tmf.mel_frontend(frames.t().contiguous().t(), *tables)
    with pytest.raises(TypeError, match="float32"):
        tmf.mel_frontend(frames.double(), *tables)
    with pytest.raises(ValueError, match="on cpu"):
        tmf.mel_frontend(frames, tables[0].cpu(), *tables[1:])
    with pytest.raises(ValueError, match="expected"):
        tmf.mel_frontend(frames, tables[0], tables[1][:, :-1], *tables[2:])
    # 32 frames of L 2048 and 1,025 bins need 393,344 bytes of shared
    # memory, past the 227 KB a block may have: refused, not tiled smaller
    big = torch.zeros(2048, 1025, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        tmf.mel_frontend(torch.zeros(4, 2048, device=cuda_device),
                         torch.zeros(2048, device=cuda_device), big, big,
                         torch.zeros(1025, 40, device=cuda_device))
