"""The mel frontend's launch plan (``kernels/mel_frontend.py::_plan``) and
its kernel's arithmetic, held on the CPU.  No JAX.

The plan: every frame and every bin is covered once (frame tiles, bin
groups of whole tiles of 8, each warp's share of its group), a group never
holds more bin tiles than its block shape takes, shared memory stays
within a block's 227 KB, a cluster holds at most 8 blocks, and the serving
shapes fill the H100's 132 SMs.

The arithmetic: the kernel runs both DFT products on the tensor cores in
TF32, each operand split into two TF32 parts (hi = round(a), lo =
round(a - hi), to nearest with ties away from zero), three products
hi*lo, lo*hi, hi*hi a group of 8 samples, as ``mma.sync.m16n8k8`` does.
The tensor cores add each group into their f32 sum by truncation, so the
kernel starts every stage of 16 samples from zero and adds the stage's
sum into its running sum with a rounded f32 add.  A numpy emulation of
that stays within ``chip_smoke.py``'s ``MEL_ATOL`` of the plain version;
with one TF32 product (no split) it does not, and truncating over all of
K drifts further from the plain version than the staged sums."""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import keyword_audio
from repro_torch.dsp import blocks
from repro_torch.kernels import mel_frontend as mf
from repro_torch.kernels import ref

SMEM_MAX = 232_448       # bytes of shared memory a block may take (H100)
MEL_ATOL = 1e-4          # chip_smoke.py's limit, kernel against plain
F32 = np.float32


def _covered(f, nbins, p):
    """Frames and bins of each block of plan p, as the kernel derives them
    from its block index and cluster rank."""
    c = mf.CONFIGS[p.config]
    frames = np.zeros(f, int)
    bins = np.zeros((p.frame_tiles, nbins), int)
    groups = mf.group_tiles(nbins, p.groups)
    for tile in range(p.frame_tiles):
        lo_f, hi_f = tile * c.tm, min(f, (tile + 1) * c.tm)
        frames[lo_f:hi_f] += 1
        for t_lo, t_hi in groups:
            for w_lo, w_hi in mf.warp_tiles(t_hi - t_lo, c.warps_n):
                assert w_hi - w_lo <= c.nt
                for t in range(t_lo + w_lo, t_lo + w_hi):
                    bins[tile, 8 * t:min(nbins, 8 * t + 8)] += 1
    return frames, bins


@pytest.mark.parametrize("nbins", [129, 257])
@pytest.mark.parametrize("f", [1, 99, 3136, 50_688, 50_689])
def test_plan_covers_every_frame_and_bin_once(f, nbins):
    p = mf._plan(f, 320, nbins, 40)
    c = mf.CONFIGS[p.config]
    assert p.tm == c.tm and p.blocks == p.frame_tiles * p.groups
    assert (p.frame_tiles - 1) * c.tm < f <= p.frame_tiles * c.tm
    groups = mf.group_tiles(nbins, p.groups)
    assert groups[0][0] == 0 and groups[-1][1] == -(-nbins // 8)
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(0 < hi - lo <= c.max_tiles for lo, hi in groups)
    frames, bins = _covered(f, nbins, p)
    assert (frames == 1).all() and (bins == 1).all()


def test_shared_memory_and_cluster_within_the_kernels_limits():
    """Over the Impulse's shapes and a sweep of ragged ones, up to n_fft
    1024 (513 bins): at most 8 blocks a cluster and at most 227 KB of
    shared memory.  Past what 8 groups of the widest block shape hold
    in one pass (1,025 bins), the groups loop over passes: still at most 8
    groups, each pass within a block shape's tiles
    (``tests/test_torch_mel_bins.py`` sweeps every bin count)."""
    for f in (1, 16, 99, 128, 256, 1000, 3136, 50_688, 50_689):
        for l, nbins in ((256, 129), (320, 257), (400, 257), (512, 257),
                         (640, 257), (1024, 513)):
            for n_mels in (32, 40, 64, 128):
                p = mf._plan(f, l, nbins, n_mels)
                assert 1 <= p.groups <= mf.MAX_GROUPS, (f, l, nbins, p)
                assert p.smem <= SMEM_MAX, (f, l, nbins, n_mels, p)
    p = mf._plan(4, 2048, 1025, 40)
    assert 1 <= p.groups <= mf.MAX_GROUPS and p.passes > 1
    assert p.smem <= SMEM_MAX


@pytest.mark.parametrize("f,n_mels", [(50_688, 40), (3136, 32)])
def test_full_width_and_quickstart_fill_the_card(f, n_mels):
    """At least one block an SM: the KWS batch of 512 clips and the
    quickstart's 64 half-second clips (32 mels)."""
    assert mf._plan(f, 320, 257, n_mels).blocks >= mf.SMS == 132


def test_one_clip_runs_on_as_many_blocks_as_the_bins_allow():
    """A single one-second clip (99 frames, the batch-1 path) takes the
    16-frame blocks and the 8 groups a cluster holds: 56 blocks, against
    4 of the first design's 32-frame blocks."""
    p = mf._plan(99, 320, 257, 40)
    assert (p.tm, p.groups, p.blocks) == (16, 8, 56)


def _tf32(a):
    """Round to TF32 (10 mantissa bits), to nearest, ties away from zero,
    as the kernel's ``tf32_rna``: add half an ulp of TF32, truncate."""
    bits = np.ascontiguousarray(a, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32((a - hi).astype(F32))


def _truncate(x):
    """float64 -> f32, rounded toward zero (the tensor cores' sums)."""
    r = x.astype(F32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], F32(0))
    return r


def _dft(xw, table, parts, stage=16):
    """sum_t xw[:, t] * table[t, :] as the kernel forms it: for each group
    of 8 samples the TF32 terms' exact products added into a truncated f32
    sum, which restarts from zero every ``stage`` samples and joins the
    running sum with a rounded add.  parts 1: one TF32 product; 3: the
    split."""
    if parts == 1:
        terms = [(_tf32(xw), _tf32(table))]
    else:
        (xh, xl), (th, tl) = _split(xw), _split(table)
        terms = [(xl, th), (xh, tl), (xh, th)]
    acc = np.zeros((xw.shape[0], table.shape[1]), F32)
    for k0 in range(0, xw.shape[1], stage):
        part = np.zeros_like(acc)
        for k in range(k0, min(xw.shape[1], k0 + stage), 8):
            for a, b in terms:
                part = _truncate(part.astype(np.float64)
                                 + a[:, k:k + 8].astype(np.float64)
                                 @ b[k:k + 8])
        acc = (acc + part).astype(F32)
    return acc


def _emulate(frames, window, cos, sin, mel, parts, stage=16):
    xw = (frames * window).astype(F32)
    re, im = _dft(xw, cos, parts, stage), _dft(xw, sin, parts, stage)
    power = (re * re + im * im).astype(F32)
    out = (power @ mel).astype(F32)
    return np.log(np.maximum(out, F32(ref.LOG_FLOOR))).astype(F32)


def _case(name):
    """(frames (F, L), window, cos, sin, mel) f32 numpy."""
    if name == "dense_F128_L256":
        rng = np.random.RandomState(3)
        f, l, nbins, n_mels = 128, 256, 129, 40
        kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / l
        return tuple(a.astype(F32) for a in (
            rng.randn(f, l), np.hanning(l), np.cos(kk), -np.sin(kk),
            rng.rand(nbins, n_mels)))
    quick = name == "quickstart_clips"     # 32 mels, half-second clips
    blk = blocks.MFEBlock(n_mels=32) if quick else blocks.MFEBlock()
    tables = tuple(t.numpy() for t in blk.tables("cpu"))
    if name == "silence":
        return (np.zeros((99, blk.frame_len), F32),) + tables
    samples = keyword_audio(n_per_class=1, n_classes=4 if quick else 12,
                            n_samples=8000 if quick else 16_000,
                            seed=2 if quick else 0)
    sig = torch.from_numpy(np.stack([s.data for s in samples[:4]]))
    frames = blocks.frame_signal(sig, blk.frame_len, blk.stride)
    return (frames.reshape(-1, blk.frame_len).numpy(),) + tables


CASES = ("keyword_clips", "quickstart_clips", "dense_F128_L256", "silence")


def _errors(name):
    arrays = _case(name)
    want = ref.mel_frontend_ref(*(torch.from_numpy(a) for a in arrays))
    want = want.numpy()
    return {parts: float(np.abs(_emulate(*arrays, parts) - want).max())
            for parts in (1, 3)}, want, arrays


@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_stay_within_the_limit(name):
    errs, want, arrays = _errors(name)
    assert errs[3] <= MEL_ATOL, errs
    if name == "silence":
        got = _emulate(*arrays, 3)
        assert (got == want).all() and (got == F32(np.log(F32(1e-6)))).all()


def test_one_tf32_product_exceeds_the_limit():
    """Why the split is there: one TF32 product puts the keyword clips'
    log-mel about 1e-2 off."""
    errs = {name: _errors(name)[0][1] for name in CASES[:3]}
    assert max(errs.values()) > MEL_ATOL, errs
    assert errs["keyword_clips"] > 10 * MEL_ATOL, errs


def test_staged_sums_stay_closer_to_plain_than_truncating_over_all_of_k():
    """Why each stage restarts from zero: truncating into one sum over all
    320 samples moves the quickstart's log-mel further from the plain
    version than the kernel's staged sums do (far enough that the card's
    logits left phase 6's 2^-17 of the CPU's)."""
    arrays = _case("quickstart_clips")
    want = ref.mel_frontend_ref(*(torch.from_numpy(a) for a in arrays))
    staged, whole = (float(np.abs(_emulate(*arrays, 3, stage) - want.numpy())
                           .max()) for stage in (16, arrays[0].shape[1]))
    assert staged < 0.75 * whole, (staged, whole)
