"""The bf16 tensor-core attention kernels at the edges of their tiles, on
the card.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_flash_attention_tiles_cuda.py

The bf16 kernels cut the sequence into tiles of 64 query rows and 64
keys: these cases put S just below and above one and two tiles (63, 65,
127, 129) and far from a multiple (1,000), windows that are no multiple
of the key tile (33, 100), GQA groups of 1, 2 and 4, and head dims 64
and 128.  This file imports neither JAX nor the JAX package.

Limits, unchanged from ``tests/test_torch_flash_attention_cuda.py`` and
``chip_smoke.py``, elementwise against the plain version computed in f32
from the same inputs: the output within its own rounding, 2^-8 of its
size, plus 1e-5; each gradient, against the plain backward given the
kernel's own output, within the same rounding plus 2^-12 of its median
magnitude.  The rows' log-sum-exp within 2^-16 of max(1, |lse|) (f32
sums in another order, and exp2/log2 with the scale folded in).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

OUT_RTOL, OUT_ATOL = 2.0 ** -8, 1e-5
GRAD_MEDIAN_ATOL = 2.0 ** -12
LSE_RTOL = 2.0 ** -16

# name: (B, S, Hq, Hkv, D, causal, window)
CASES = {
    "s63_g2_d128": (1, 63, 4, 2, 128, True, 0),
    "s64_g4_d64": (2, 64, 4, 1, 64, True, 0),
    "s65_g1_d64": (2, 65, 2, 2, 64, True, 0),
    "s127_g4_d128": (1, 127, 8, 2, 128, True, 0),
    "s129_g2_d64_full": (1, 129, 4, 2, 64, False, 0),
    "s1000_g4_d128": (1, 1000, 4, 1, 128, True, 0),
    "s200_window100_g2_d128": (1, 200, 4, 2, 128, True, 100),
    "s300_window33_full_g1_d64": (1, 300, 2, 2, 64, False, 33),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, s, hq, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(dev).to(torch.bfloat16)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))]


def _within(got, want, atol):
    lim = OUT_RTOL * want.abs() + atol
    return float(((got.float() - want).abs() / lim).max())


def _lse_ref(q, k, causal, window):
    """log-sum-exp of each row's scaled, masked scores: (B, Hq, S)."""
    g = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    s, d = q.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = i[None, :] <= i[:, None]
    if window > 0:
        mask = mask & (i[None, :] > i[:, None] - window)
    return torch.where(mask, scores, -torch.inf).logsumexp(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_forward_at_tile_edges(cuda_device, case):
    b, s, hq, hkv, d, causal, window = CASES[case]
    q, k, v, _ = _inputs(cuda_device, b, s, hq, hkv, d, seed=2)
    before = tfa.LAUNCHES["flash_attention"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                    window)
    assert out.dtype == torch.bfloat16 and bool(out.isfinite().all())
    assert _within(out, want, OUT_ATOL) <= 1
    want_lse = _lse_ref(q, k, causal, window)
    assert float(((lse - want_lse).abs()
                  / want_lse.abs().clamp(min=1.0)).max()) <= LSE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_backward_at_tile_edges(cuda_device, case):
    b, s, hq, hkv, d, causal, window = CASES[case]
    q, k, v, do = _inputs(cuda_device, b, s, hq, hkv, d, seed=3)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = tfa.LAUNCHES["flash_attention_bwd"]
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd"] == before + 1
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out, do)), causal, window)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
        atol = GRAD_MEDIAN_ATOL * float(w.abs().median())
        assert _within(got, w, atol) <= 1


@pytest.mark.cuda
def test_bf16_kernels_are_deterministic(cuda_device):
    """No atomics: two runs give the same bits, forward and backward (dK
    and dV summed over a group of 4 query heads)."""
    q, k, v, do = _inputs(cuda_device, 2, 300, 8, 2, 128, seed=4)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        runs.append((out, lse, *tfa.flash_attention_bwd(q, k, v, out, lse,
                                                        do, causal=True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
