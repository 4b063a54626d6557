"""The arithmetic of the bf16 tensor-core attention kernels, rehearsed on
the CPU.

``kernels/csrc/flash_attention.cu`` runs every product of the bf16 path on
the tensor cores: bf16 operands, f32 sums.  Q, K, V and dO are bf16
already, so S = Q K^T and dP = dO V^T are exact products summed in f32,
and ``scale`` multiplies the f32 sum afterwards.  The second products take
P (forward, dV) or dS (dK, dQ) as a bf16 operand: the kernels split each
f32 value exactly into bf16 hi + lo and issue both parts into the same
f32 accumulator.  This file emulates that arithmetic in plain torch --
the forward tile by tile (64 keys) with the online softmax in base 2, as
the kernel runs it; the backward from the forward's lse -- and holds it
against the plain versions, ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``, at the limits ``chip_smoke.py`` holds the
card to: the output within its own rounding (2^-8 of each value) plus
1e-5 (``TOL[bf16]``); each gradient within that rounding plus 2^-12 of
its median magnitude (``FA_GRAD_ATOL`` by ``grad_reading``'s rule).  It
also pins why the split is there: P or dS rounded once to bf16 fails
those limits.  No JAX; nothing on the port's path uses the emulation.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL = 2.0 ** -8, 1e-5          # chip_smoke.TOL[bf16]
FA_GRAD_ATOL = 2.0 ** -12                     # chip_smoke.FA_GRAD_ATOL
TILE = 64                                     # keys a tile in the kernels
LOG2E = 1.4426950408889634

# name: (B, S, Hq, Hkv, D, causal, window)
CASES = {
    "causal_g2_d128": (1, 256, 4, 2, 128, True, 0),
    "causal_g1_d64": (1, 256, 2, 2, 64, True, 0),
    "window48_g2_d64": (1, 256, 4, 2, 64, True, 48),
    "full_g1_d128": (1, 192, 2, 2, 128, False, 0),
    "ragged_s77_g2_d64": (2, 77, 4, 2, 64, True, 0),
}


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))]


def _mask(s, causal, window):
    i = torch.arange(s)
    qp, kp = i[:, None], i[None, :]
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep = kp <= qp
    if window > 0:
        keep = keep & (kp > qp - window)
    return keep


def _split(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The bf16 operand the kernel feeds the tensor cores, back in f32:
    hi + lo (x to 16 significant bits) when split, else bf16(x)."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def _heads(q, k, v):
    """(B, H, S, D) f32 views, the KV heads expanded to the query heads."""
    g = q.shape[2] // k.shape[2]
    return (q.float().transpose(1, 2),
            k.float().repeat_interleave(g, 2).transpose(1, 2),
            v.float().repeat_interleave(g, 2).transpose(1, 2))


def emulate_forward(q, k, v, causal, window, split=True):
    """The forward kernel's arithmetic: (out bf16 (B, S, Hq, D), lse f32
    (B, Hq, S)).  Tiles of 64 keys; x = (Q K^T) * scale * log2(e) in f32,
    masked keys -inf; online softmax in base 2 with m starting at -1e30;
    o = o * alpha + P V with P hi + lo; out = o / max(l, 1e-30)."""
    qh, kh, vh = _heads(q, k, v)
    s, d = q.shape[1], q.shape[3]
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    keep = _mask(s, causal, window)
    m = torch.full(qh.shape[:3], -1e30)
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    for k0 in range(0, s, TILE):
        x = (qh @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)) * scale_log2
        x = torch.where(keep[:, k0:k0 + TILE], x, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _split(p, split) @ vh[:, :, k0:k0 + TILE]
        m = m_new
    out = (o / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
    lse = (m + torch.log2(l)) * math.log(2.0)
    return out.transpose(1, 2), lse


def emulate_backward(q, k, v, out, lse, do, causal, window, split=True):
    """The backward kernels' arithmetic: (dq, dk, dv) in bf16.  P =
    exp2(S * scale * log2(e) - lse * log2(e)) under the mask, dP = dO V^T,
    dS = P (dP - Dr) with Dr = rowsum(dO * out) over the bf16 output; dV =
    P^T dO and dK = scale dS^T Q, dQ = scale dS K with P and dS hi + lo; dK
    and dV summed over the group in f32 before their one rounding."""
    qh, kh, vh = _heads(q, k, v)
    b, s, hkv, d = k.shape
    g = q.shape[2] // hkv
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    doh = do.float().transpose(1, 2)
    dr = (do.float() * out.float()).sum(-1).transpose(1, 2)
    x = (qh @ kh.transpose(-1, -2)) * scale_log2 - (lse * LOG2E)[..., None]
    p = torch.where(_mask(s, causal, window), torch.exp2(x), 0.0)
    ds = p * (doh @ vh.transpose(-1, -2) - dr[..., None])
    dv = _split(p, split).transpose(-1, -2) @ doh
    dk = (_split(ds, split).transpose(-1, -2) @ qh) * scale
    dq = (_split(ds, split) @ kh) * scale
    dk, dv = (t.transpose(1, 2).reshape(b, s, hkv, g, d).sum(3)
              for t in (dk, dv))
    return tuple(t.to(torch.bfloat16) for t in (dq.transpose(1, 2), dk, dv))


def out_reading(got, want):
    """Largest |got - want| in units of the bf16 output's limit."""
    lim = OUT_RTOL * want.abs() + OUT_ATOL
    return float(((got.float() - want).abs() / lim).max())


def grad_reading(got, want):
    """``chip_smoke.grad_reading``'s share of the limit: the output's
    rounding plus FA_GRAD_ATOL of the median magnitude."""
    w = want.abs()
    lim = OUT_RTOL * w + FA_GRAD_ATOL * float(w.median())
    return float(((got.float() - want).abs() / lim).max())


def _case(name):
    b, s, hq, hkv, d, causal, window = CASES[name]
    q, k, v, do = _inputs(b, s, hq, hkv, d)
    return q, k, v, do, causal, window


@pytest.mark.parametrize("case", list(CASES))
def test_forward_split_within_limit(case):
    q, k, v, _, causal, window = _case(case)
    out, lse = emulate_forward(q, k, v, causal, window)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                    window)
    assert out_reading(out, want) <= 1
    assert bool(lse.isfinite().all())


@pytest.mark.parametrize("case", list(CASES))
def test_backward_split_within_limit(case):
    q, k, v, do, causal, window = _case(case)
    out, lse = emulate_forward(q, k, v, causal, window)
    grads = emulate_backward(q, k, v, out, lse, do, causal, window)
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out, do)), causal, window)
    for got, w in zip(grads, want):
        assert grad_reading(got, w) <= 1


def test_lse_matches_logsumexp():
    """The forward's lse, rebuilt in base 2, is the rows' log-sum-exp of
    the scaled scores (f32)."""
    q, k, v, _, causal, window = _case("window48_g2_d64")
    _, lse = emulate_forward(q, k, v, causal, window)
    qh, kh, _ = _heads(q, k, v)
    scores = (qh @ kh.transpose(-1, -2)) * q.shape[3] ** -0.5
    want = torch.where(_mask(q.shape[1], causal, window), scores,
                       -torch.inf).logsumexp(-1)
    assert float((lse - want).abs().max()) <= 2.0 ** -16 * float(
        want.abs().max())


def test_split_is_exact_to_16_bits():
    """hi + lo carries x to 16 significant bits: within 2^-16 of |x|."""
    x = torch.from_numpy(np.random.RandomState(5).rand(4096)
                         .astype(np.float32))
    err = (_split(x, True) - x).abs() / x
    assert float(err.max()) <= 2.0 ** -16
    assert float(((_split(x, False) - x).abs() / x).max()) > 2.0 ** -10


def test_p_rounded_once_fails_the_forward_limit():
    """Why the kernels split P: rounded once to bf16 before P V, the
    output leaves the limit (an error of about 2^-9 of the output's scale,
    not of each value)."""
    q, k, v, _, causal, window = _case("causal_g2_d128")
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                    window)
    once, _ = emulate_forward(q, k, v, causal, window, split=False)
    split, _ = emulate_forward(q, k, v, causal, window, split=True)
    assert out_reading(once, want) > 4
    assert out_reading(split, want) <= 1


def test_p_and_ds_rounded_once_fail_the_gradient_limit():
    """The same for the backward: P and dS rounded once to bf16."""
    q, k, v, do, causal, window = _case("causal_g2_d128")
    out, lse = emulate_forward(q, k, v, causal, window)
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out, do)), causal, window)
    once = emulate_backward(q, k, v, out, lse, do, causal, window,
                            split=False)
    assert max(grad_reading(g, w) for g, w in zip(once, want)) > 1
