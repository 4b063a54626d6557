"""The mel-frontend CUDA kernel past one pass of a cluster, on the card:
the 48 kHz MFE Impulse's frontends (n_fft 2048 and 4096: 1,025 and 2,049
bins) and every block shape forced to loop its groups over passes,
against the plain PyTorch version.  Skipped without a GPU (marker
``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_mel_bins_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  Tolerance as in ``tests/test_torch_mel_cuda.py``:
elementwise |kernel - plain| <= 1e-4 on the log-mel, both in f32; two runs
bitwise equal.  ``chip_smoke.py`` repeats the check at 512 clips and times
the kernel.
"""
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
    return out


# the 48 kHz MFE blocks: (frame_s, n_fft) -> L 1,536 / 1,025 bins and L
# 3,072 / 2,049 bins, 40 mels
MFE_48K = {"n_fft2048": (0.032, 2048), "n_fft4096": (0.064, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("n_clips", [3, 300])
@pytest.mark.parametrize("name", list(MFE_48K))
def test_48khz_mfe_any_bins(cuda_device, name, n_clips):
    """The 48 kHz MFE Impulse's frontend, 1 s clips: 3 clips (the
    16-frame blocks, 8 groups in passes) and 300 (the 128-frame blocks,
    one group in 17 or 33 passes) against the plain version; two runs
    bitwise equal (the sums over bins, passes and groups in a fixed
    order)."""
    frame_s, n_fft = MFE_48K[name]
    blk = tblocks.MFEBlock(sample_rate=48_000, frame_s=frame_s,
                           stride_s=0.016, n_mels=40, n_fft=n_fft)
    frames = tblocks.frame_signal(_clips(n_clips, 48_000, cuda_device),
                                  blk.frame_len, blk.stride)
    tables = blk.tables(cuda_device)
    assert tables[1].shape == (blk.frame_len, n_fft // 2 + 1)
    out = _check(frames, tables)
    again = tops.mel_frontend(frames, *tables)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [0, 1, 2])
@pytest.mark.parametrize("groups", [1, 3, 8])
def test_every_block_shape_in_passes(cuda_device, monkeypatch, config,
                                     groups):
    """Each block shape at 1, 3 and 8 groups over 2,049 bins (257 tiles:
    every group in passes, some groups one tile longer than others), the
    plan forced, against the plain version."""
    rng = np.random.RandomState(5)
    f, l, nbins, n_mels = 150, 1024, 2049, 24
    kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / 4096
    frames, *tables = (torch.from_numpy(a.astype(np.float32))
                       .to(cuda_device)
                       for a in (rng.randn(f, l) * 0.1, np.hanning(l),
                                 np.cos(kk), -np.sin(kk),
                                 rng.rand(nbins, n_mels)))
    plan = tmf._make(config, f, l, -(-nbins // 8), n_mels, groups)
    assert plan.passes > 1
    monkeypatch.setattr(tmf, "_plan", lambda *a: plan)
    _check(frames, tables)
