"""DSP preprocessing blocks (paper §4.2): the feature extractors the
Impulse pipeline composes with model blocks.

The counterpart of ``repro.dsp.blocks``: the same blocks, fields,
``feature_shape`` and ``hyperparams``.  Each block is a callable on a
``(B, T)`` signal tensor (or ``(B, H, W, C)`` images) that runs on the
tensor's device.  The heavy path (framing, window, DFT, mel) dispatches
through ``kernels/ops.mel_frontend``: the CUDA kernel on the card, the
plain PyTorch version on the CPU.  The spectrogram and the MFCC DCT are
plain products, as in the JAX package.

The window and the DFT, mel and DCT tables are built once per block and
device and kept (the JAX package rebuilds them on every call); the values
are the same.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.dsp import filterbank as fb
from repro_torch.kernels import ops as kops


def frame_signal(signal: torch.Tensor, frame_len: int, stride: int
                 ) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_len), n_frames = 1 + (T -
    frame_len) // stride: a view of the signal (frames overlap when
    stride < frame_len), no copy."""
    return signal.unfold(-1, frame_len, stride)


def _window(frame_len: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(frame_len).astype(np.float32)) \
        .to(device)


@functools.lru_cache(maxsize=None)
def _dft_tables(frame_len: int, n_fft: int, device: torch.device):
    cos, sin = fb.dft_matrices(frame_len, n_fft)
    return (_window(frame_len, device), torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


@functools.lru_cache(maxsize=None)
def _mel_table(n_fft: int, n_mels: int, sample_rate: int,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fb.mel_filterbank(
        n_fft // 2 + 1, n_mels, sample_rate)).to(device)


@functools.lru_cache(maxsize=None)
def _dct_table(n_mels: int, n_coeffs: int, device: torch.device
               ) -> torch.Tensor:
    return torch.from_numpy(fb.dct_matrix(n_mels, n_coeffs)).to(device)


@dataclasses.dataclass(frozen=True)
class MFEBlock:
    """Mel-filterbank energies.  Hyperparameters mirror the paper's
    Table 3 notation: MFE(frame_s, stride_s, n_mels)."""
    sample_rate: int = 16_000
    frame_s: float = 0.02
    stride_s: float = 0.01
    n_mels: int = 40
    n_fft: int = 512
    name: str = "mfe"

    @property
    def frame_len(self) -> int:
        return int(self.sample_rate * self.frame_s)

    @property
    def stride(self) -> int:
        return int(self.sample_rate * self.stride_s)

    def feature_shape(self, n_samples: int) -> Tuple[int, int]:
        n_frames = 1 + (n_samples - self.frame_len) // self.stride
        return (n_frames, self.n_mels)

    def tables(self, device: torch.device):
        """window (L,), cos and sin (L, nbins), mel (nbins, n_mels), f32
        on ``device``, built at the first call for the device."""
        window, cos, sin = _dft_tables(self.frame_len, self.n_fft, device)
        return window, cos, sin, _mel_table(self.n_fft, self.n_mels,
                                            self.sample_rate, device)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        """(B, T) audio -> (B, n_frames, n_mels) log-mel."""
        frames = frame_signal(signal.float(), self.frame_len, self.stride)
        return kops.mel_frontend(frames, *self.tables(signal.device))

    def hyperparams(self):
        return {"frame_s": self.frame_s, "stride_s": self.stride_s,
                "n_mels": self.n_mels}


@dataclasses.dataclass(frozen=True)
class MFCCBlock:
    """MFCCs = DCT-II of the log-mel energies."""
    sample_rate: int = 16_000
    frame_s: float = 0.02
    stride_s: float = 0.01
    n_mels: int = 40
    n_coeffs: int = 13
    n_fft: int = 512
    name: str = "mfcc"

    @property
    def _mfe(self) -> MFEBlock:
        return MFEBlock(self.sample_rate, self.frame_s, self.stride_s,
                        self.n_mels, self.n_fft)

    def feature_shape(self, n_samples: int) -> Tuple[int, int]:
        return (self._mfe.feature_shape(n_samples)[0], self.n_coeffs)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        logmel = self._mfe(signal)
        return logmel @ _dct_table(self.n_mels, self.n_coeffs, signal.device)

    def hyperparams(self):
        return {"frame_s": self.frame_s, "stride_s": self.stride_s,
                "n_mels": self.n_mels, "n_coeffs": self.n_coeffs}


@dataclasses.dataclass(frozen=True)
class SpectrogramBlock:
    sample_rate: int = 16_000
    frame_s: float = 0.02
    stride_s: float = 0.01
    n_fft: int = 256
    name: str = "spectrogram"

    def feature_shape(self, n_samples: int) -> Tuple[int, int]:
        frame_len = int(self.sample_rate * self.frame_s)
        stride = int(self.sample_rate * self.stride_s)
        return (1 + (n_samples - frame_len) // stride, self.n_fft // 2 + 1)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        frame_len = int(self.sample_rate * self.frame_s)
        stride = int(self.sample_rate * self.stride_s)
        frames = frame_signal(signal.float(), frame_len, stride)
        window, cos, sin = _dft_tables(frame_len, self.n_fft, signal.device)
        xw = frames * window
        re = xw @ cos
        im = xw @ sin
        return torch.log(torch.clamp(re * re + im * im, min=1e-6))

    def hyperparams(self):
        return {"frame_s": self.frame_s, "stride_s": self.stride_s,
                "n_fft": self.n_fft}


@dataclasses.dataclass(frozen=True)
class RawBlock:
    """Pass-through (normalized raw signal): the 'no DSP' end of the
    paper's continuum."""
    name: str = "raw"

    def feature_shape(self, n_samples: int) -> Tuple[int]:
        return (n_samples,)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        s = signal.float()
        mu = s.mean(dim=-1, keepdim=True)
        sd = s.std(dim=-1, keepdim=True, correction=0) + 1e-6
        return (s - mu) / sd

    def hyperparams(self):
        return {}


@dataclasses.dataclass(frozen=True)
class ImageNormBlock:
    """Image scaling block for the VWW / image-classification pipelines."""
    name: str = "image_norm"

    def feature_shape(self, hwc: Tuple[int, int, int]):
        return hwc

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return images.float() / 127.5 - 1.0

    def hyperparams(self):
        return {}
