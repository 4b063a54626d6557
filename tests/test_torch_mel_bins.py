"""The mel frontend at any bin count, on the CPU: n_fft up to 8192 (4,097
bins), as a 44.1 or 48 kHz MFE Impulse sets it (n_fft 2048 or 4096 for a
32 to 64 ms frame).

The plan (``kernels/mel_frontend.py::_plan``) for every bin count from 1
to 4,097 at frame lengths up to 4,096: every frame and every bin is
covered once (frame tiles, bin groups of whole tiles of 8, each group's
passes of at most a block shape's tiles, each warp's share of a pass),
at most 8 groups a cluster and one a bin tile, shared memory within the
227 KB a block takes and as the kernel lays it out: never a plan the
kernel refuses.  Up to 1,024 bins every group runs in one pass.

The plain version (``ref.mel_frontend_ref``, the CPU path of
``ops.mel_frontend``) against the JAX package's Pallas kernel in
interpret mode and its plain version at 1,025 and 2,049 bins (F <= 128,
which the Pallas kernel takes), and the port's 48 kHz ``MFEBlock``
against the JAX package's on tables that are bitwise equal, at atol 1e-4
on the log-mel (both sum in f32 in another order).  Inputs are made with
numpy from a seed.  The kernel is held against the plain version on the
card (``tests/test_torch_mel_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import keyword_audio
from repro.dsp import blocks as jblocks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.dsp import blocks as tblocks
from repro_torch.kernels import mel_frontend as mf
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ATOL = 1e-4
SMEM_MAX = 232_448
CPU = torch.device("cpu")
# the 48 kHz MFE blocks: frame_s, n_fft -> L 1,536 / 1,025 bins, L 3,072 /
# 2,049 bins
MFE_48K = {"n_fft2048": (0.032, 2048), "n_fft4096": (0.064, 4096)}


# (block shape, groups, nbins) -> the walk's verdict: the bins' coverage
# depends on these alone
_WALKED = {}


def _bins_covered_once(plan, nbins: int) -> bool:
    """In each frame tile each bin tile once (tile t: bins [8 t, 8 t + 8)
    below nbins), as the kernel derives its work from its cluster rank,
    pass and warp; passes of at most the block shape's tiles, a warp's
    share at most its NT, the fullest group in ``plan.passes``."""
    key = (plan.config, plan.groups, nbins)
    if key in _WALKED:
        return _WALKED[key]
    c = mf.CONFIGS[plan.config]
    tiles, passes, ok = [], 0, True
    for g_lo, g_hi in mf.group_tiles(nbins, plan.groups):
        steps = mf.pass_tiles(g_hi - g_lo, c.max_tiles)
        passes = max(passes, len(steps))
        for p_lo, p_hi in steps:
            ok &= 0 < p_hi - p_lo <= c.max_tiles
            for w_lo, w_hi in mf.warp_tiles(p_hi - p_lo, c.warps_n):
                ok &= w_hi - w_lo <= c.nt
                tiles += range(g_lo + p_lo + w_lo, g_lo + p_lo + w_hi)
    _WALKED[key] = ok and passes == plan.passes \
        and sorted(tiles) == list(range(-(-nbins // 8)))
    return _WALKED[key]


def _taken(plan, l: int, nbins: int, n_mels: int) -> bool:
    """What the kernel checks before it launches (``launch`` in
    ``csrc/mel_frontend.cu``)."""
    ntiles = -(-nbins // 8)
    c = mf.CONFIGS[plan.config]
    return (1 <= plan.groups <= min(mf.MAX_GROUPS, ntiles)
            and plan.blocks == plan.frame_tiles * plan.groups
            and plan.smem == c.smem(l, n_mels, plan.passes > 1)
            and plan.smem <= SMEM_MAX)


@pytest.mark.parametrize("l", [320, 1536, 3072, 4096])
def test_plan_for_every_bin_count(l):
    """nbins 1 to 4,097 at 1, 61 (one 48 kHz clip), 3,904 and 31,232
    frames (the batch of 512 clips), 40 mels: taken, every frame and every
    bin covered once, one pass up to 1,024 bins."""
    for nbins in range(1, 4098):
        for f in (1, 61, 3904, 31_232):
            p = mf._plan(f, l, nbins, 40)
            c = mf.CONFIGS[p.config]
            assert _taken(p, l, nbins, 40), (f, l, nbins, p)
            assert (p.frame_tiles - 1) * c.tm < f <= p.frame_tiles * c.tm
            assert _bins_covered_once(p, nbins), (f, l, nbins, p)
            assert nbins > 1024 or p.passes == 1, (f, l, nbins, p)


@pytest.mark.parametrize("n_mels", [32, 64, 128])
def test_plan_taken_at_wider_mel_banks(n_mels):
    for nbins in (129, 257, 513, 1024, 1025, 2049, 4097):
        for l in (320, 1536, 4096):
            for f in (1, 99, 31_232):
                p = mf._plan(f, l, nbins, n_mels)
                assert _taken(p, l, nbins, n_mels), (f, l, nbins, p)


def test_one_pass_up_to_1024_bins_and_one_group_past_it():
    """Up to 1,024 bins the plan is the single-pass one (so the tuned
    Impulse shapes keep their launch); past it the batch of 512 48 kHz
    clips takes the 128-frame blocks in one group, looping over passes
    (each pass streams the frames once: the fewest groups do the least
    work), and a single clip the 16-frame blocks in 8 groups."""
    assert mf._plan(50_688, 320, 257, 40).passes == 1
    assert mf._plan(31_232, 1536, 1024, 40).passes == 1
    big = mf._plan(31_232, 1536, 1025, 40)
    assert (big.tm, big.groups, big.passes) == (128, 1, 17)
    assert mf._plan(31_232, 3072, 2049, 40).passes == 33
    one = mf._plan(61, 1536, 1025, 40)
    assert (one.tm, one.groups) == (16, 8) and one.passes == 3
    # the running partials lie past the ring: more shared memory
    c = mf.CONFIGS[big.config]
    assert big.smem == c.smem(1536, 40, True) > c.smem(1536, 40)


def _clips(n: int, n_samples: int) -> np.ndarray:
    samples = keyword_audio(n_per_class=-(-n // 4), n_classes=4,
                            n_samples=n_samples, seed=8)
    return np.stack([s.data for s in samples])[:n]


@pytest.mark.parametrize("name", list(MFE_48K))
def test_plain_matches_jax_pallas_at_many_bins(name):
    """Random frames of L 1,536 (1,025 bins) and 3,072 (2,049 bins), the
    48 kHz block's own window and DFT tables, random mel weights: the
    plain version against the Pallas kernel in interpret mode (F 64) and
    the JAX plain version."""
    frame_s, n_fft = MFE_48K[name]
    blk = jblocks.MFEBlock(sample_rate=48_000, frame_s=frame_s,
                           stride_s=0.016, n_mels=40, n_fft=n_fft)
    window, cos, sin, _ = blk._tables()
    rng = np.random.RandomState(n_fft)
    arrays = (rng.randn(64, blk.frame_len).astype(np.float32) * 0.1,
              np.asarray(window), np.asarray(cos), np.asarray(sin),
              rng.rand(n_fft // 2 + 1, 40).astype(np.float32))
    got = tref.mel_frontend_ref(
        *(torch.from_numpy(np.array(a)) for a in arrays)).numpy()
    jarrays = [jnp.asarray(a) for a in arrays]
    for want in (jops.mel_frontend(*jarrays, force="interpret"),
                 jref.mel_frontend_ref(*jarrays)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(MFE_48K))
def test_48khz_mfe_block_matches_jax(name):
    """The port's ``MFEBlock`` at 48 kHz against the JAX package's: the
    tables bitwise equal, the feature shape, and the log-mel of two 1 s
    keyword clips."""
    frame_s, n_fft = MFE_48K[name]
    kw = dict(sample_rate=48_000, frame_s=frame_s, stride_s=0.016,
              n_mels=40, n_fft=n_fft)
    jb, tb = jblocks.MFEBlock(**kw), tblocks.MFEBlock(**kw)
    for want, got in zip(jb._tables(), tb.tables(CPU)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tb.frame_len == int(48_000 * frame_s)
    assert tb.tables(CPU)[1].shape == (tb.frame_len, n_fft // 2 + 1)
    sig = _clips(2, 48_000)
    assert tb.feature_shape(48_000) == jb.feature_shape(48_000)
    got = tb(torch.from_numpy(sig)).numpy()
    want = np.asarray(jb(jnp.asarray(sig)))
    assert got.shape == want.shape == (2,) + tb.feature_shape(48_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
