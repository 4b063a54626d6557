"""``flash_attention``'s position masks on the card, against the plain
PyTorch version: forward and backward kernels given per-row positions
(``q_pos``/``k_pos``), bf16 (tensor cores) and f32 (CUDA cores), at G 8
(qwen2-vl's 64 query heads on 8 KV heads, and 16 on 2) and
D 128 and 64, on Qwen2-VL image ties, packed rows with pads at -1, a
window, and keys of another length; a pad query sees no key and must come
out finite, as the reference's uniform row (the mean of V), with an lse
near -1e30; positions equal to the index give the index kernels' output,
lse and gradients bitwise; the forward at D 80 and 256 takes positions
too.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_flash_attention_positions_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` (phases 2 and 15)
repeats the checks at qwen2-vl's full shapes.

Tolerances, as in ``tests/test_torch_flash_attention_cuda.py``: outputs
against the plain version computed in f32 from the same (rounded) inputs,
within 1e-5 in f32 and, in bf16, 1e-5 plus the output's own rounding,
2^-8 of its size; gradients against the plain backward given the
kernel's own output, the same rounding term plus, in bf16, 2^-12 of the
gradient's median magnitude, in f32 2^-16 of its largest value.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api

OUT_TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# name: (positions, B, S, Hq, Hkv, D, causal, window)
CASES = {"image_pads_g8": ("image_pads", 2, 257, 64, 8, 128, True, 0),
         "packed_pads_window": ("packed", 2, 200, 16, 2, 128, True, 32),
         "packed_pads_d64": ("packed", 2, 190, 8, 2, 64, True, 0),
         "image_pads_bidirectional": ("image_pads", 1, 130, 8, 1, 64,
                                      False, 0)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _image_row(s, shift=0):
    """The temporal stream of 7 text tokens, a 1 x 8 x 12 image (96
    patches on one position), then text, over S tokens."""
    pos = api.mrope_positions([("text", 7), ("image", (1, 8, 12)),
                               ("text", s - 103)])
    return pos[:, 0] + shift


def _packed_row(s, cut, pad):
    pos = torch.cat([torch.arange(cut), torch.arange(s - cut)])
    if pad:
        pos[-pad:] = -1
    return pos


def _positions(kind, b, s, dev):
    if kind == "image":
        rows = [_image_row(s), _image_row(s, 5)]
    elif kind == "image_pads":
        row = _image_row(s)
        rows = [torch.where(torch.arange(s) < s - 11, row, -1), row]
    else:
        rows = [_packed_row(s, s // 3, 9), _packed_row(s, s // 2, 0)]
    return torch.stack(rows[:b]).to(torch.int32).to(dev)


def _rand(dev, dtype, rng, *shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
            .to(dtype) for s in shapes]


def _within(got, want, rtol, atol):
    lim = rtol * want.abs() + atol
    return float(((got.float() - want).abs() / lim).max())


def _grad_atol(want, dtype):
    if dtype == torch.bfloat16:
        return 2.0 ** -12 * float(want.abs().median())
    return 2.0 ** -16 * float(want.abs().max())


def _case(name, dtype, dev, seed):
    kind, b, s, hq, hkv, d, causal, window = CASES[name]
    q, k, v, do = _rand(dev, dtype, np.random.RandomState(seed),
                        (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                        (b, s, hq, d))
    return q, k, v, do, _positions(kind, b, s, dev), causal, window


def _masked_lse(q, k, causal, window, qp, kp):
    """Each row's log-sum-exp over the plain version's masked scores."""
    g = q.shape[2] // k.shape[2]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                      k.float().repeat_interleave(g, 2)) / math.sqrt(
                          q.shape[-1])
    mask = tref.attention_mask(q.shape[1], k.shape[1], causal, window, qp,
                               kp)
    return torch.logsumexp(torch.where(mask, sc, tref.NEG_INF), dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_by_position(cuda_device, case, dtype):
    """The forward against ``flash_attention_ref`` with the same
    positions, every row (a pad query's mean of V too), and each row's
    lse: the masked scores' log-sum-exp where a key is visible, near
    -1e30 where none is."""
    dt = DTYPES[dtype]
    q, k, v, _, pos, causal, window = _case(case, dt, cuda_device, 1)
    before = tfa.LAUNCHES["flash_attention"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, q_pos=pos, k_pos=pos)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                    window, pos, pos)
    assert bool(out.isfinite().all())
    assert _within(out, want, *OUT_TOL[dt]) <= 1
    empty = (pos < 0)[:, None, :].expand_as(lse) if causal else \
        torch.zeros_like(lse, dtype=torch.bool)
    want_lse = _masked_lse(q, k, causal, window, pos, pos)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=1e-4,
                               rtol=1e-5)
    if bool(empty.any()):
        assert float(lse[empty].max()) < -1e29


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_by_position(cuda_device, case, dtype):
    """dq, dk, dv through ``ops.flash_attention`` with positions against
    the plain backward in f32 given the kernel's output: a pad row's
    uniform weights reach dV, its dQ is zero."""
    dt = DTYPES[dtype]
    q, k, v, do, pos, causal, window = _case(case, dt, cuda_device, 2)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tfa.LAUNCHES["flash_attention_bwd"]
    out = tops.flash_attention(*qkv, causal=causal, window=window,
                               q_pos=pos, k_pos=pos)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd"] == before + 1
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out.detach(), do)), causal, window,
        pos, pos)
    for got, w in zip(qkv, want):
        g = got.grad
        assert g.shape == got.shape and g.dtype == dt
        assert bool(g.isfinite().all())
        assert _within(g, w, OUT_TOL[dt][0], _grad_atol(w, dt)) <= 1
    if causal and bool((pos < 0).any()):
        assert float(qkv[0].grad[pos < 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_index_positions_equal_the_index_kernels(cuda_device, dtype):
    """Positions 0..S-1 give the index kernels' output, lse and gradients
    bitwise: the position kernels visit the tiles the index kernels skip,
    and add exact zeros there."""
    dt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    for causal, window in ((True, 0), (True, 48), (False, 0)):
        q, k, v, do = _rand(cuda_device, dt, rng, (2, 200, 16, 128),
                            (2, 200, 2, 128), (2, 200, 2, 128),
                            (2, 200, 16, 128))
        idx = torch.arange(200, dtype=torch.int32,
                           device=cuda_device)[None].repeat(2, 1)
        runs = []
        for pos in (None, idx):
            out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                               window=window, q_pos=pos,
                                               k_pos=pos)
            grads = tfa.flash_attention_bwd(q, k, v, out, lse, do,
                                            causal=causal, window=window,
                                            q_pos=pos, k_pos=pos)
            runs.append((out, lse) + grads)
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_keys_of_another_length_by_position(cuda_device, dtype):
    """Sq 100 queries at the end of a key row of 300 (three key pads),
    causal by position, forward and backward against the plain
    version."""
    dt = DTYPES[dtype]
    rng = np.random.RandomState(4)
    q, k, v, do = _rand(cuda_device, dt, rng, (2, 100, 16, 128),
                        (2, 300, 2, 128), (2, 300, 2, 128),
                        (2, 100, 16, 128))
    kpos = torch.arange(300, dtype=torch.int32)[None].repeat(2, 1)
    kpos[1, -3:] = -1
    qpos = kpos[:, 197:297].contiguous().to(cuda_device)
    kpos = kpos.to(cuda_device)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, q_pos=qpos,
                                       k_pos=kpos)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), True,
                                    0, qpos, kpos)
    assert _within(out, want, *OUT_TOL[dt]) <= 1
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                    q_pos=qpos, k_pos=kpos)
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out, do)), True, 0, qpos, kpos)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert _within(g, w, OUT_TOL[dt][0], _grad_atol(w, dt)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
def test_forward_by_position_d80_d256(cuda_device, d):
    """The forward at zamba2's and gemma3's head dims takes positions
    (image ties with pads, bf16 and f32), and so does the backward (once
    refused there): each gradient against the plain backward by position,
    f32 within 2^-16 of its largest magnitude, bf16 within its rounding
    plus 2^-10 of its median (``chip_smoke.py``'s ``FA_WIDE_GRAD_ATOL``)."""
    for dt in (torch.bfloat16, torch.float32):
        rng = np.random.RandomState(d)
        q, k, v, do = _rand(cuda_device, dt, rng, (2, 257, 4, d),
                            (2, 257, 2, d), (2, 257, 2, d), (2, 257, 4, d))
        pos = _positions("image_pads", 2, 257, cuda_device)
        kw = dict(causal=True, window=64, q_pos=pos, k_pos=pos)
        out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
        want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        True, 64, pos, pos)
        assert bool(out.isfinite().all())
        assert _within(out, want, *OUT_TOL[dt]) <= 1
        grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        wants = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                             out.float(), do.float(), True,
                                             64, pos, pos)
        for g, w in zip(grads, wants):
            assert bool(g.isfinite().all())
            if dt == torch.float32:
                lim = 2.0 ** -16 * w.abs().max()
            else:
                lim = 2.0 ** -8 * w.abs() + 2.0 ** -10 * w.abs().median()
            assert bool(((g.float() - w).abs() <= lim).all())


@pytest.mark.cuda
def test_position_arguments_are_checked(cuda_device):
    """One position tensor without the other, a wrong shape, dtype or
    device raise before any launch."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    pos = torch.arange(64, dtype=torch.int32, device=cuda_device)[None]
    before = dict(tfa.LAUNCHES)
    bad = [dict(q_pos=pos), dict(q_pos=pos, k_pos=pos[:, :32]),
           dict(q_pos=pos, k_pos=pos.long()),
           dict(q_pos=pos, k_pos=pos.cpu())]
    for kw in bad:
        with pytest.raises(ValueError):
            tfa.flash_attention_fwd(q, q, q, **kw)
    assert tfa.LAUNCHES == before
