"""Port parity: the DSP tables, framing, the mel frontend and the five DSP
blocks against the JAX package, on the CPU.

The tables (window, DFT, mel, DCT) are numpy in both packages and must be
bitwise equal.  The plain mel frontend (``ref.mel_frontend_ref``, the CPU
path of ``ops.mel_frontend``) is held against the Pallas kernel in
interpret mode where the kernel takes the frame count (F <= 128 or a
multiple of 128: it asserts ``F % block_f == 0``) and against the JAX
plain version everywhere, ragged F included, at atol 1e-4 on the log-mel
(measured gaps are below 1e-5 at these sizes: both sum in f32 in another
order).  Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import keyword_audio
from repro.dsp import blocks as jblocks
from repro.dsp import filterbank as jfb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.dsp import blocks as tblocks
from repro_torch.dsp import filterbank as tfb
from repro_torch.kernels import mel_frontend as tmf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ATOL = 1e-4
CPU = torch.device("cpu")


def _clips(n: int, n_samples: int = 16_000) -> np.ndarray:
    """``n`` synthetic keyword clips (the repo's own generator), (n, T)."""
    samples = keyword_audio(n_per_class=-(-n // 4), n_classes=4,
                            n_samples=n_samples, seed=3)
    return np.stack([s.data for s in samples[::max(1, len(samples) // n)]]
                    )[:n]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# tables and framing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {},                                     # MFE defaults: L 320, n_fft 512
    {"n_mels": 32, "sample_rate": 16_000},  # the quickstart's MFCC frontend
    {"frame_s": 0.04},                      # L 640 > n_fft 512: wrapped
    {"frame_s": 0.032, "n_fft": 1024, "n_mels": 64},
])
def test_tables_bitwise(kw):
    jb, tb = jblocks.MFEBlock(**kw), tblocks.MFEBlock(**kw)
    for want, got in zip(jb._tables(), tb.tables(CPU)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filterbank_functions_bitwise():
    np.testing.assert_array_equal(tfb.mel_filterbank(129, 20, 8000),
                                  jfb.mel_filterbank(129, 20, 8000))
    np.testing.assert_array_equal(tfb.dct_matrix(40, 13),
                                  jfb.dct_matrix(40, 13))
    for args in ((320, 512), (256, None), (640, 512)):
        for got, want in zip(tfb.dft_matrices(*args),
                             jfb.dft_matrices(*args)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfb.hz_to_mel([0.0, 700.0, 8000.0]),
                                  jfb.hz_to_mel([0.0, 700.0, 8000.0]))


@pytest.mark.parametrize("t,frame_len,stride", [(16_000, 320, 160),
                                                (8000, 320, 160),
                                                (1000, 256, 100)])
def test_frame_signal_is_a_view_equal_to_jax(t, frame_len, stride):
    sig = np.random.RandomState(t).randn(3, t).astype(np.float32)
    want = np.asarray(jblocks.frame_signal(jnp.asarray(sig), frame_len,
                                           stride))
    src = _t(sig)
    got = tblocks.frame_signal(src, frame_len, stride)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.data_ptr() == src.data_ptr()            # no copy
    assert got.stride() == (t, stride, 1)


def test_tables_built_once_per_device():
    blk = tblocks.MFEBlock()
    first = blk.tables(CPU)
    again = tblocks.MFEBlock().tables(CPU)
    assert all(a is b for a, b in zip(first, again))


# ---------------------------------------------------------------------------
# the mel frontend
# ---------------------------------------------------------------------------
def _mel_case(f, l, nbins, n_mels, seed=3):
    """Random frames and the kernel test's tables (n_fft = L, random mel
    weights), as ``tests/test_kernels.py`` builds them."""
    rng = np.random.RandomState(seed)
    frames = rng.randn(f, l).astype(np.float32)
    window = np.hanning(l).astype(np.float32)
    kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / l
    return (frames, window, np.cos(kk).astype(np.float32),
            (-np.sin(kk)).astype(np.float32),
            rng.rand(nbins, n_mels).astype(np.float32))


def _audio_case(f):
    """``f`` overlapping frames of a keyword clip with the MFE defaults'
    tables (L 320, 257 bins, 40 mels)."""
    sig = _clips(2 + (f * 160) // 16_000).reshape(-1)
    frames = np.asarray(jblocks.frame_signal(jnp.asarray(sig), 320, 160))[:f]
    return (frames,) + tuple(np.asarray(x)
                             for x in jblocks.MFEBlock()._tables())


@pytest.mark.parametrize("case", [
    "random_128_256_129_40", "random_256_512_257_32", "audio_99",
    "audio_1", "audio_198", "audio_333"])
def test_mel_frontend_ref_matches_jax(case):
    kind, *dims = case.split("_")
    dims = [int(d) for d in dims]
    arrays = _mel_case(*dims) if kind == "random" else _audio_case(*dims)
    f = arrays[0].shape[0]
    got = tref.mel_frontend_ref(*map(_t, arrays)).numpy()
    jarrays = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jref.mel_frontend_ref(*jarrays))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if f <= 128 or f % 128 == 0:
        pallas = np.asarray(jops.mel_frontend(*jarrays, force="interpret"))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_ops_mel_frontend_folds_leading_dims_on_cpu():
    """``ops.mel_frontend`` on the CPU is the plain version, leading dims
    kept, on ``frame_signal``'s view of a (2, 3, T) batch."""
    sig = _clips(6, 4000).reshape(2, 3, 4000)
    blk = tblocks.MFEBlock()
    tables = blk.tables(CPU)
    frames = tblocks.frame_signal(_t(sig), blk.frame_len, blk.stride)
    got = tops.mel_frontend(frames, *tables)
    assert got.shape == (2, 3, 24, 40)
    want = np.asarray(jref.mel_frontend_ref(
        jnp.asarray(np.asarray(frames)),
        *[jnp.asarray(x) for x in jblocks.MFEBlock()._tables()]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_silence_gives_the_exact_floor():
    floor = np.float32(math.log(np.float32(1e-6)))
    silence = np.zeros((2, 16_000), np.float32)
    got = tblocks.MFEBlock()(_t(silence)).numpy()
    want = np.asarray(jblocks.MFEBlock()(jnp.asarray(silence)))
    assert got.shape == (2, 99, 40)
    np.testing.assert_array_equal(got, want)
    assert np.all(got == floor) and abs(float(floor) + 13.8155) < 1e-4


def test_cuda_wrapper_refuses_cpu_tensors():
    frames, *tables = map(_t, _mel_case(8, 256, 129, 40))
    before = tmf.LAUNCHES["mel_frontend"]
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on cpu"):
        tmf.mel_frontend(frames, *tables)
    assert tmf.LAUNCHES["mel_frontend"] == before


# ---------------------------------------------------------------------------
# the five DSP blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw,n_samples", [
    ("MFEBlock", {}, 16_000),
    ("MFEBlock", {"frame_s": 0.04, "n_mels": 32}, 16_000),
    ("MFCCBlock", {"n_mels": 32, "n_coeffs": 10}, 8000),
    ("MFCCBlock", {}, 16_000),
    ("SpectrogramBlock", {}, 16_000),
    ("RawBlock", {}, 8000),
])
def test_audio_blocks_match_jax(name, kw, n_samples):
    sig = _clips(8, n_samples)
    jb, tb = getattr(jblocks, name)(**kw), getattr(tblocks, name)(**kw)
    want = np.asarray(jb(jnp.asarray(sig)))
    got = tb(_t(sig)).numpy()
    assert tb.feature_shape(n_samples) == jb.feature_shape(n_samples)
    assert got.shape == want.shape == (8,) + tb.feature_shape(n_samples)
    assert tb.hyperparams() == jb.hyperparams() and tb.name == jb.name
    if name != "SpectrogramBlock":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    # A near-cancelled bin (the DC bin of a windowed zero-mean frame, power
    # ~5e-5) carries f32 rounding of a few 1e-4 on its log in either
    # package: the JAX output is 4.5e-4 from the float64 value there.  So
    # 1e-4 holds on the bins of power >= e^-5 (99.4% of them), and on all
    # bins the port is no further from the float64 value than JAX is.
    exact = _spectrogram_f64(sig, tb)
    strong = exact >= -5.0
    assert strong.mean() > 0.99
    np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=ATOL)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def _spectrogram_f64(sig: np.ndarray, blk) -> np.ndarray:
    frame_len = int(blk.sample_rate * blk.frame_s)
    stride = int(blk.sample_rate * blk.stride_s)
    frames = np.asarray(jblocks.frame_signal(jnp.asarray(sig), frame_len,
                                             stride)).astype(np.float64)
    cos, sin = jfb.dft_matrices(frame_len, blk.n_fft)
    xw = frames * np.hanning(frame_len).astype(np.float32)
    power = (xw @ cos.astype(np.float64)) ** 2 \
        + (xw @ sin.astype(np.float64)) ** 2
    return np.log(np.maximum(power, 1e-6))


def test_image_norm_block_matches_jax():
    img = np.random.RandomState(0).randint(0, 256, (4, 32, 32, 3)) \
        .astype(np.uint8)
    jb, tb = jblocks.ImageNormBlock(), tblocks.ImageNormBlock()
    np.testing.assert_array_equal(tb(_t(img)).numpy(),
                                  np.asarray(jb(jnp.asarray(img))))
    assert tb.feature_shape((32, 32, 3)) == jb.feature_shape((32, 32, 3))
    assert tb.hyperparams() == jb.hyperparams() == {}
