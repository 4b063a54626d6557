"""The enc-dec backbone's kernels on the card, against their plain PyTorch
versions: ``flash_attention`` forward and backward with keys of another
length than the queries (cross-attention: ``causal=False``, every key
visible), at D 64 and 128 (the forward at D 80 and 256 too), bf16 and
f32, a ragged pair and the full shape; its refusal of an index mask
between two lengths; both serving kernels at D 64 and G 1 (seamless-m4t:
16 query heads on 16 KV heads) against the decoder's self cache and the
encoder's cross cache (query position 2^30, pad queries at -1), float and
int8; and a small float32 enc-dec config (d_model 256, 4 heads: D 64, the
kernels' least) on the card against the CPU.  Skipped without a GPU
(marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_encdec_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` (phases 2 and 14)
repeats the checks at the full model's shapes.

Tolerances, as in ``tests/test_torch_flash_attention_cuda.py``: outputs
against the plain version computed in f32 from the same (rounded) inputs,
within 1e-5 in f32 and, in bf16, 1e-5 plus the output's own rounding,
2^-8 of its size; gradients against the plain backward given the
kernel's own output, the same rounding term plus, in bf16, 2^-12 of the
gradient's median magnitude, in f32 2^-16 of its largest value.  The
small config's logits against the CPU within 1e-4 (f32 sums in another
order), its greedy tokens equal.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api, encdec
from repro_torch.models import transformer as ttr
from repro_torch.models.params import init_params

OUT_TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CROSS = 2 ** 30

# name: (B, Sq, Skv, Hq, Hkv, D): the ragged pair and the full shape of
# seamless-m4t's cross-attention (16/16 heads of 64), more keys than
# queries at D 128 with GQA; the forward at D 80 and 256 too
FWD_CASES = {"ragged_1000_250": (1, 1000, 250, 16, 16, 64),
             "full_2048_512": (2, 2048, 512, 16, 16, 64),
             "gqa_d128_77_300": (1, 77, 300, 4, 2, 128),
             "d80_300_100": (1, 300, 100, 4, 4, 80),
             "d256_130_64": (1, 130, 64, 2, 1, 256)}
BWD_CASES = ("ragged_1000_250", "full_2048_512", "gqa_d128_77_300")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_other_key_length(cuda_device, case, dtype):
    """The forward kernel at Sq != Skv against ``flash_attention_ref``,
    and each row's log-sum-exp over all Skv keys (a kernel that kept one
    S would read past k's end or leave keys unread)."""
    b, sq, skv, hq, hkv, d = FWD_CASES[case]
    dt = DTYPES[dtype]
    q, k, v = _rand(cuda_device, dt, np.random.RandomState(5),
                    (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    before = tfa.LAUNCHES["flash_attention"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape and lse.shape == (b, hq, sq)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), False)
    assert _within(out, want, *OUT_TOL[dt]) <= 1
    kr = k.float().repeat_interleave(hq // hkv, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    torch.testing.assert_close(lse, torch.logsumexp(sc, dim=-1), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_other_key_length(cuda_device, case, dtype):
    """dq (B, Sq, ...), dk and dv (B, Skv, ...) through ``ops.flash_
    attention`` against the plain backward in f32, given the kernel's
    output: the dK/dV pass sums every query tile of every key tile, the
    dQ pass every key tile."""
    b, sq, skv, hq, hkv, d = FWD_CASES[case]
    dt = DTYPES[dtype]
    q, k, v, do = _rand(cuda_device, dt, np.random.RandomState(6),
                        (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                        (b, sq, hq, d))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tfa.LAUNCHES["flash_attention_bwd"]
    out = tops.flash_attention(*qkv, causal=False)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd"] == before + 1
    want = tref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out.detach(), do)), False)
    for got, w in zip(qkv, want):
        g = got.grad
        assert g.shape == got.shape and g.dtype == dt
        assert bool(g.isfinite().all())
        assert _within(g, w, OUT_TOL[dt][0], _grad_atol(w, dt)) <= 1


@pytest.mark.cuda
def test_other_key_length_refused_under_an_index_mask(cuda_device):
    """``causal=True`` or a window with Sq != Skv raises in the wrapper,
    forward and backward, before any launch; the entry points refuse it
    too."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    before = dict(tfa.LAUNCHES)
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="causal=False"):
            tfa.flash_attention_fwd(q, k, k, **kw)
        with pytest.raises(ValueError, match="causal=False"):
            tfa.flash_attention_bwd(q, k, k, q, lse, q, **kw)
        with pytest.raises(ValueError, match="causal=False"):
            tops.flash_attention(q, k, k, **kw)
    assert tfa.LAUNCHES == before


def _kv(k, v, dtype, int8):
    if not int8:
        return k, v, k.float(), v.float()
    kc, vc = tq.quant_kv(k), tq.quant_kv(v)
    return (kc, vc) + tuple(tq.dequant_kv(x, dtype).float()
                            for x in (kc, vc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_serving_kernels_at_d64_g1(cuda_device, dtype, int8):
    """Both serving kernels at seamless-m4t's heads (16/16 of 64): decode
    and a chunk of 16 with a pad tail against the self cache (capacity
    128, fills 0, 1, 37, 128), and the cross reads: every slot's 512
    encoder entries, ``kv_len`` None, from query position 2^30 (pad
    queries -1: exact zeros)."""
    dt = DTYPES[dtype]
    rng = np.random.RandomState(8)
    h, d = 16, 64
    for s, cross in ((128, False), (512, True)):
        k, v = _rand(cuda_device, dt, rng, (4, s, h, d), (4, s, h, d))
        kc, vc, kf, vf = _kv(k, v, dt, int8)
        fills = [s] * 4 if cross else [0, 1, 37, s]
        pos = torch.full((4, s), -1, dtype=torch.int32)
        for i, n in enumerate(fills):
            pos[i, :n] = torch.arange(n)
        pos = pos.to(cuda_device)
        kvl = None if cross else torch.tensor(fills, dtype=torch.int32,
                                              device=cuda_device)
        qp = torch.full((4,), CROSS, dtype=torch.int32) if cross else \
            torch.tensor([max(n - 1, 0) for n in fills], dtype=torch.int32)
        qp = qp.to(cuda_device)
        q, = _rand(cuda_device, dt, rng, (4, 1, h, d))
        out = tops.decode_attention(q, kc, vc, qp, pos, kv_len=kvl)
        want = tref.decode_attention_ref(q.float(), kf, vf, qp, pos,
                                         kv_len=kvl)
        assert _within(out, want, *OUT_TOL[dt]) <= 1
        if not cross:
            assert torch.all(out[0] == 0)
        reals = [16, 9, 16, 3]
        cqp = torch.full((4, 16), -1, dtype=torch.int32)
        for i, r in enumerate(reals):
            first = 0 if cross else max(fills[i] - r, 0)
            cqp[i, :r] = CROSS if cross else torch.arange(first, first + r)
        cqp = cqp.to(cuda_device)
        q, = _rand(cuda_device, dt, rng, (4, 16, h, d))
        out = tops.chunk_attention(q, kc, vc, cqp, pos, kv_len=kvl)
        want = tref.chunk_attention_ref(q.float(), kf, vf, cqp, pos,
                                        kv_len=kvl)
        assert _within(out, want, *OUT_TOL[dt]) <= 1
        for i, r in enumerate(reals):
            assert torch.all(out[i, r:] == 0)


def small_encdec_config():
    """The smoke config in float32 at d_model 256 and 4 heads: head dim
    64, the least the card's kernels take (the smoke config's 16 runs only
    the plain versions)."""
    return dataclasses.replace(configs.get_smoke("seamless-m4t-large-v2"),
                               d_model=256, dtype="float32")


@pytest.mark.cuda
def test_small_encdec_on_card_matches_cpu(cuda_device):
    """The small float32 config on the card against the CPU: one-shot
    prefill, ``grow_cache`` and 6 greedy decode steps, and the chunked
    path (chunks of 4), logits within 1e-4 and the same greedy tokens; the
    training loss and every gradient within 1e-4 of their scale; the cross
    caches unchanged by decode and chunk steps."""
    cfg = small_encdec_config()
    assert cfg.resolved_head_dim == 64
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       trainable=True)
    card = copy.deepcopy(host).to(cuda_device)
    inputs = api.synthetic_inputs(cfg, 2, 16, torch.Generator()
                                  .manual_seed(1), device="cpu")
    runs = {}
    for dev, params in (("cpu", host), (cuda_device, card)):
        x = {k: t.to(dev) for k, t in inputs.items()}
        with torch.no_grad():
            logits, cache = encdec.forward_prefill(
                cfg, params, {k: x[k] for k in ("enc_embeddings", "tokens")})
            cache = ttr.grow_cache(cfg, cache, 8)
            xk = cache["xk"].clone()
            seq, toks = [logits], [logits.argmax(-1).to(torch.int32)]
            for t in range(6):
                lg, cache = encdec.forward_decode(
                    cfg, params, cache, toks[-1],
                    torch.full((2,), 16 + t, dtype=torch.int32, device=dev))
                seq.append(lg)
                toks.append(lg.argmax(-1).to(torch.int32))
            assert torch.equal(cache["xk"], xk)
            chunked = encdec.init_chunk_cache(cfg, params,
                                              x["enc_embeddings"], 16)
            xv = chunked["xv"].clone()
            for p in range(0, 16, 4):
                pos = torch.arange(p, p + 4, dtype=torch.int32,
                                   device=dev)[None].repeat(2, 1)
                lc, chunked = encdec.forward_prefill_chunk(
                    cfg, params, chunked, x["tokens"][:, p:p + 4], pos)
            assert torch.equal(chunked["xv"], xv)
        loss, _ = encdec.forward_train(cfg, params, x, remat="full")
        grads = torch.autograd.grad(loss, list(params.parameters()))
        runs[str(dev)] = (torch.stack(seq).cpu(), torch.stack(toks).cpu(),
                          lc[:, -1].cpu(), loss.item(),
                          [g.cpu() for g in grads])
    (s0, t0, c0, l0, g0), (s1, t1, c1, l1, g1) = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(s1, s0, atol=1e-4, rtol=0)
    assert torch.equal(t1, t0)
    torch.testing.assert_close(c1, c0, atol=1e-4, rtol=0)
    assert abs(l1 - l0) <= 1e-5
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max())
                                   + 1e-7, rtol=0)
