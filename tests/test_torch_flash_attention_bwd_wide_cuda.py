"""``flash_attention``'s backward at head dims 80 (zamba2's shared block,
on tiles of 128) and 256 (gemma3: two blocks a head, half of D each)
against the plain backward, on the card: bf16 and f32, causal, windowed,
full over ragged S, masked by position (packed rows with pads), GQA.
Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_flash_attention_bwd_wide_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the checks at
the training paths' full shapes and times the kernels.

Tolerances, as ``chip_smoke.py`` holds the same kernels: against the
plain backward in f32 from the same (rounded) inputs and the kernel's own
forward output; f32 within 2^-16 of each gradient's largest magnitude;
bf16 within the output's rounding (2^-8 of each value) plus
``FA_WIDE_GRAD_ATOL`` (2^-10) of the gradient's median magnitude.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

FA_WIDE_GRAD_ATOL = 2.0 ** -10
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# name: (B, S, Hq, Hkv, causal, window, packed positions)
CASES = {"causal": (1, 300, 4, 4, True, 0, False),
         "gqa_window": (2, 200, 8, 4, True, 64, False),
         "full_ragged": (1, 77, 2, 1, False, 0, False),
         "packed": (2, 150, 4, 2, True, 0, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(b, s, dev):
    """Two sequences a row (the second from position 0 again), the last
    entries pads at -1."""
    rows = []
    for i in range(b):
        cut = s // 3 + 7 * i
        row = torch.cat([torch.arange(cut), torch.arange(s - cut)])
        row[s - 5 - i:] = -1
        rows.append(row)
    return torch.stack(rows).to(torch.int32).to(dev)


def check_backward(dev, d, dtype, b, s, hq, hkv, causal, window, packed,
                   seed=0):
    """The kernels' (dq, dk, dv) at head dim ``d`` against the plain
    backward; returns the kernels' gradients."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev, dtype) for h in (hq, hkv, hkv, hq))
    pos = _packed(b, s, dev) if packed else None
    kw = dict(causal=causal, window=window, q_pos=pos, k_pos=pos)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        out.float(), do.float(), causal,
                                        window, pos, pos)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(g.isfinite().all()), name
        diff = (g.float() - w).abs()
        if dtype == torch.float32:
            lim = 2.0 ** -16 * w.abs().max()
        else:
            lim = 2.0 ** -8 * w.abs() + FA_WIDE_GRAD_ATOL * w.abs().median()
        assert bool((diff <= lim).all()), (name, float((diff / lim).max()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_against_plain(cuda_device, d, dtype, case):
    check_backward(cuda_device, d, DTYPES[dtype], *CASES[case])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
def test_autograd_through_the_kernels(cuda_device, d):
    """``ops.flash_attention`` under autograd (the operator
    ``repro_torch::flash_attention`` with its registered backward) launches
    the forward once and the backward once, and gives the backward
    kernel's gradients."""
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 130, h, d)
                                    .astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for h in (4, 2, 2, 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_launches()
    out = tops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1}
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    want = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
def test_two_runs_give_the_same_bits(cuda_device, d):
    """No atomics: the backward is deterministic."""
    a = check_backward(cuda_device, d, torch.bfloat16, *CASES["gqa_window"],
                       seed=2)
    b = check_backward(cuda_device, d, torch.bfloat16, *CASES["gqa_window"],
                       seed=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
