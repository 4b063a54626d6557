"""``flash_attention``'s forward and backward at head dims off their tile
widths, against their plain PyTorch versions, on the card: D 16 (every
smoke config: d_model 64 over 4 heads) and 48 on tiles of 64, D 96 on
tiles of 128, D 192 on the two-blocks-a-head tile of 256; causal GQA,
windowed, full, and masked by position over packed rows, at ragged S.
Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_head_dims_fa_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the checks at
internlm2-1.8b's training shape.

Tolerances, as in ``tests/test_torch_d80_cuda.py``: against the plain
version computed in f32 from the same (rounded) inputs, within 1e-5 in
f32 and, in bf16, 1e-5 plus the output's own rounding, 2^-8 of its size;
gradients within that rounding plus 2^-10 of each one's median (bf16) or
2^-16 of its largest value (f32).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

TRAINING_DIMS = (16, 48, 96, 192)
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(dev, dtype, *arrays):
    out = [torch.from_numpy(a).to(dev) for a in arrays]
    return [t.to(dtype) if t.is_floating_point() else t for t in out]


def _check(out, want, dtype, d):
    assert out.shape[-1] == d and bool(out.isfinite().all())
    torch.testing.assert_close(out.float(), want, atol=1e-5,
                               rtol=RTOL[dtype])


def _pos_rows(b, s, rng):
    """Packed rows: two sequences a row, positions restarting, a pad tail
    at -1."""
    pos = np.full((b, s), -1, np.int32)
    for i in range(b):
        cut, end = s // 3 + 7 * i, s - 5 - 3 * i
        pos[i, :cut] = np.arange(cut)
        pos[i, cut:end] = np.arange(end - cut)
    return pos


# name: (B, S, Hq, Hkv, causal, window, by position)
FA_CASES = {"causal_gqa_s130": (2, 130, 4, 2, True, 0, False),
            "window_48_s200": (1, 200, 4, 4, True, 48, False),
            "full_s77": (1, 77, 2, 1, False, 0, False),
            "packed_b2_s150": (2, 150, 4, 2, True, 0, True)}


def _check_case(dev, d, case, dtype):
    b, s, hq, hkv, causal, window, by_pos = FA_CASES[case]
    rng = np.random.RandomState(60 + d)
    q, k, v, do = _to(dev, dtype,
                      *(rng.randn(b, s, h, d).astype(np.float32)
                        for h in (hq, hkv, hkv, hq)))
    pos = _to(dev, dtype, _pos_rows(b, s, rng))[0] if by_pos \
        else None
    kw = dict(causal=causal, window=window, q_pos=pos, k_pos=pos)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    f32 = [t.float() for t in (q, k, v)]
    want = tref.flash_attention_ref(*f32, causal, window, pos, pos)
    _check(out, want, dtype, d)
    assert bool(lse.isfinite().all()), case
    if pos is None:
        g = hq // hkv
        sc = torch.einsum("bqhd,bkhd->bhqk", f32[0],
                          f32[1].repeat_interleave(g, 2)) / math.sqrt(d)
        mask = tref.attention_mask(s, s, causal, window,
                                   device=dev)
        if mask is not None:
            sc = sc.masked_fill(~mask, float("-inf"))
        want_lse = torch.logsumexp(sc, -1)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    want_g = tref.flash_attention_bwd_ref(*f32, out.float(), do.float(),
                                          causal, window, pos, pos)
    for got, w in zip(grads, want_g):
        assert got.shape == w.shape and bool(got.isfinite().all())
        if dtype == torch.bfloat16:
            lim = 2.0 ** -8 * w.abs() + 2.0 ** -10 * w.abs().median()
        else:
            lim = 2.0 ** -16 * w.abs().max()
        assert bool(((got.float() - w).abs() <= lim).all()), case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", TRAINING_DIMS)
def test_flash_attention_at_head_dim(cuda_device, d, dtype):
    """The whole-sequence forward (its log-sum-exp at the scale 1/sqrt(D)
    too) and the backward against their plain versions, causal, windowed,
    full and masked by position, over ragged S (each case of
    ``FA_CASES``)."""
    for case in FA_CASES:
        _check_case(cuda_device, d, case, DTYPES[dtype])
