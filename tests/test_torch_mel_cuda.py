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
@pytest.mark.parametrize("f,l,nbins,n_mels,hop,config,groups", [
    (50_688, 320, 257, 40, 160, 0, 5),   # 128 frames a block, 5 groups
    (3136, 320, 257, 32, 160, 1, 3),     # 64 frames a block, 3 groups
    (99, 320, 257, 40, 161, 2, 8),       # 16 frames, 8 groups; rows not
                                         # 16-byte aligned (4-byte copies)
    (7, 200, 65, 20, 37, 2, 8),          # ragged L and bins
    (300, 1024, 513, 40, 512, 1, 8),     # n_fft 1024: 8 groups of 9 tiles
])
def test_each_plan_branch_matches_plain(cuda_device, f, l, nbins, n_mels,
                                        hop, config, groups):
    """Every block shape of the plan, one and several bin groups, the
    16-byte and the 4-byte frame copies, against the plain version on
    DFT tables of n_fft = 2 (nbins - 1) and a random filterbank."""
    plan = tmf._plan(f, l, nbins, n_mels)
    assert (plan.config, plan.groups) == (config, groups)
    rng = np.random.RandomState(f)
    n_fft = 2 * (nbins - 1)
    kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / n_fft
    sig, window, cos, sin, mel = (
        torch.from_numpy(a.astype(np.float32)).to(cuda_device)
        for a in (rng.randn((f - 1) * hop + l) * 0.3, np.hanning(l),
                  np.cos(kk), -np.sin(kk), rng.rand(nbins, n_mels)))
    frames = tblocks.frame_signal(sig, l, hop)
    assert frames.shape == (f, l) and frames.stride() == (hop, 1)
    _check(frames, (window, cos, sin, mel))


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
def test_nan_frames_give_nan_as_the_plain_version(cuda_device):
    """A NaN sample makes every output of its frame NaN, as in the plain
    version; the other frames stay finite and within the limit (the
    kernel's rounding to TF32 keeps NaN)."""
    blk = tblocks.MFEBlock()
    sig = _clips(2, 16_000, cuda_device).clone()
    sig[1, 5000] = float("nan")
    frames = tblocks.frame_signal(sig, blk.frame_len, blk.stride)
    tables = blk.tables(cuda_device)
    out = tops.mel_frontend(frames, *tables)
    want = tref.mel_frontend_ref(frames, *tables)
    torch.cuda.synchronize()
    nan_rows = want.isnan().any(-1)
    assert int(nan_rows.sum()) == 2 and bool(want[nan_rows].isnan().all())
    assert torch.equal(out.isnan(), want.isnan())
    err = float((out[~nan_rows] - want[~nan_rows]).abs().max())
    assert err <= ATOL, err


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


@pytest.mark.cuda
def test_bins_past_one_cluster_pass(cuda_device):
    """1,025 bins (129 tiles of 8), more than the 8 groups of 16 tiles a
    cluster of the widest block shape holds in one pass, once refused:
    four frames of 2,048 samples against the plain version, the groups
    looping over passes."""
    rng = np.random.RandomState(4)
    l, nbins = 2048, 1025
    kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / l
    frames, *tables = (torch.from_numpy(a.astype(np.float32))
                       .to(cuda_device)
                       for a in (rng.randn(4, l) * 0.1, np.hanning(l),
                                 np.cos(kk), -np.sin(kk),
                                 rng.rand(nbins, 40)))
    assert tmf._plan(4, l, nbins, 40).passes > 1
    _check(frames, tables)
