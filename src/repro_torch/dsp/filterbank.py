"""Mel filterbank + DFT-matrix construction (host-side, numpy).

The port's own copy of ``repro.dsp.filterbank``: the same tables bit for
bit.  The DFT is expressed as two dense matrices, so the frontend is one
chain of products (``kernels/csrc/mel_frontend.cu`` fuses them); the
mel conventions follow librosa/CMSIS-DSP closely enough for the paper's
KWS pipeline.
"""
from __future__ import annotations

import numpy as np


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_bins: int, n_mels: int, sample_rate: int,
                   fmin: float = 20.0, fmax: float | None = None
                   ) -> np.ndarray:
    """(n_bins, n_mels) triangular filters; n_bins = n_fft//2 + 1."""
    fmax = fmax or sample_rate / 2
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    n_fft = (n_bins - 1) * 2
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = bins[m], bins[m + 1], bins[m + 2]
        for b in range(lo, min(ctr, n_bins)):
            if ctr > lo:
                fb[b, m] = (b - lo) / (ctr - lo)
        for b in range(ctr, min(hi, n_bins)):
            if hi > ctr:
                fb[b, m] = (hi - b) / (hi - ctr)
    return fb


def dft_matrices(frame_len: int, n_fft: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as two dense matrices: (L, n_bins) cos and -sin."""
    n_fft = n_fft or frame_len
    n_bins = n_fft // 2 + 1
    t = np.arange(frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def dct_matrix(n_mels: int, n_coeffs: int) -> np.ndarray:
    """Type-II orthonormal DCT (n_mels, n_coeffs) — MFCC from log-mel."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_coeffs)[None, :]
    d = np.cos(np.pi * (n + 0.5) * k / n_mels)
    d *= np.sqrt(2.0 / n_mels)
    d[:, 0] /= np.sqrt(2.0)
    return d.astype(np.float32)
