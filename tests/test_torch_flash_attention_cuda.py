"""The whole-sequence attention kernels (forward and backward) against
their plain PyTorch version, on the card.  Skipped without a GPU (marker
``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_flash_attention_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the check at
the training path's full shapes.

Tolerances, elementwise against the plain version computed in f32 from
the same inputs: a bf16 output may differ by its own rounding, 2^-8 of
its size, plus 1e-5; an f32 output by 1e-5.  Gradients, against the
backward's plain version (``ref.flash_attention_bwd_ref``) given the
kernel's own output, so that only the summation order differs: the same
rounding term plus, in bf16, 2^-12 of the gradient's median magnitude
(``chip_smoke.py``'s ``FA_GRAD_ATOL``, set from its readings, which
``PERF.md`` gives), in f32 2^-16 of its largest value.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params

OUT_TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}


# name: (B, S, Hq, Hkv, D, causal, window)
CASES = {
    "causal_gqa": (2, 128, 4, 2, 128, True, 0),
    "ragged_s100": (1, 100, 4, 4, 64, True, 0),
    "full_ragged_s77": (2, 77, 2, 1, 128, False, 0),
    "window_32": (1, 200, 4, 2, 128, True, 32),
    "window_full_40": (1, 150, 2, 2, 64, False, 40),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, s, hq, hkv, d, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(dev).to(dtype)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))]


def _within(got, want, rtol, atol):
    lim = rtol * want.abs() + atol
    return float(((got.float() - want).abs() / lim).max())


def _grad_atol(want, dtype):
    if dtype == torch.bfloat16:
        return 2.0 ** -12 * float(want.abs().median())
    return 2.0 ** -16 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_plain(cuda_device, case, dtype):
    b, s, hq, hkv, d, causal, window = CASES[case]
    dt = DTYPES[dtype]
    q, k, v, _ = _inputs(cuda_device, b, s, hq, hkv, d, dt)
    before = tfa.LAUNCHES["flash_attention"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal, window)
    assert out.dtype == dt and out.shape == q.shape
    assert bool(out.isfinite().all()) and bool(lse.isfinite().all())
    assert _within(out, want, *OUT_TOL[dt]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_plain(cuda_device, case, dtype):
    """dq, dk, dv through ``ops.flash_attention`` (the autograd Function)
    against the plain backward in f32, given the kernel's output."""
    b, s, hq, hkv, d, causal, window = CASES[case]
    dt = DTYPES[dtype]
    q, k, v, do = _inputs(cuda_device, b, s, hq, hkv, d, dt, seed=1)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tfa.LAUNCHES["flash_attention_bwd"]
    out = tops.flash_attention(*qk, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd"] == before + 1
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out.detach(), do)), causal, window)
    rtol = OUT_TOL[dt][0]
    for got, w in zip(qk, want):
        g = got.grad
        assert g.dtype == dt and bool(g.isfinite().all())
        assert _within(g, w, rtol, _grad_atol(w, dt)) <= 1


@pytest.mark.cuda
def test_refused_shapes_raise(cuda_device):
    """What the kernels do not take raises; it never quietly takes the
    plain path on a CUDA tensor."""
    def qkv(d, dtype=torch.bfloat16, hq=2, hkv=2):
        return [torch.zeros(1, 8, h, d, dtype=dtype, device=cuda_device)
                for h in (hq, hkv, hkv)]
    for d in (32, 96, 320):
        with pytest.raises(ValueError, match="head_dim"):
            tops.flash_attention(*qkv(d))
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention(*qkv(64, hq=3, hkv=2))
    q, k, v = qkv(64)
    with pytest.raises(TypeError, match="dtypes"):
        tfa.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(TypeError, match="dtypes"):
        tfa.flash_attention_fwd(*qkv(64, torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu())


@pytest.mark.cuda
def test_training_step_launch_counts(cuda_device):
    """forward_train with remat "full" on a small f32 config (head_dim 64):
    L forward launches, L more when the backward recomputes each block,
    and L backward launches; with remat "none", L and L."""
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              d_model=128, n_heads=2, n_kv_heads=1,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device, trainable=True)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40))
                                 .astype(np.int32)).to(cuda_device)
             for k in ("tokens", "labels")}
    n = cfg.n_layers
    for remat, fwd in (("full", 2 * n), ("none", n)):
        tfa.reset_launches()
        loss, _ = ttr.forward_train(cfg, params, batch, remat=remat)
        assert tfa.LAUNCHES == {"flash_attention": n,
                                "flash_attention_bwd": 0}
        loss.backward()
        torch.cuda.synchronize()
        assert tfa.LAUNCHES == {"flash_attention": fwd,
                                "flash_attention_bwd": n}
        assert bool(loss.isfinite())
