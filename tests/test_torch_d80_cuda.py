"""The attention kernels at head dim 80 (zamba2's shared block: 32 query
heads on 32 KV heads, G 1), against their plain PyTorch versions, on the
card: the serving kernels (``flash_decode``, ``flash_chunk_prefill``) on a
contiguous cache and on a paged pool whose unmapped blocks are poisoned,
float and int8 K/V, and ``flash_attention``'s forward, causal, windowed
and full, and its backward at D 80.  The kernels compute on tiles of
128 columns and read the cache's 80; the softmax scale is 1/sqrt(80).
Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_d80_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the checks at
the serving and prefill paths' full shapes.

Tolerances, as in ``tests/test_torch_kernels_cuda.py``: against the plain
version computed in f32 from the same (rounded) inputs, within 1e-5 in
f32 and, in bf16, 1e-5 plus the output's own rounding, 2^-8 of its size.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

D = 80
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


def _check(out, want, dtype):
    assert out.shape[-1] == D
    torch.testing.assert_close(out.float(), want, atol=1e-5,
                               rtol=RTOL[dtype])


def _kv(k, v, dtype, int8):
    """The cache leaves as given or as ``Int8KV``, and what the plain
    version reads: the values dequantized and rounded as the kernel
    rounds them."""
    if not int8:
        return k.clone(), v.clone(), k.float(), v.float()
    kc, vc = tq.quant_kv(k), tq.quant_kv(v)
    return (kc, vc) + tuple(tq.dequant_kv(x, dtype).float()
                            for x in (kc, vc))


def _slots(leaf, n):
    """The first ``n`` slots of a cache leaf (a tensor or ``Int8KV``)."""
    if isinstance(leaf, tq.Int8KV):
        return tq.Int8KV(leaf.q[:n], leaf.scale[:n])
    return leaf[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_serving_kernels_at_d80(cuda_device, dtype, int8):
    """Decode with 4 slots (fills 0, 1, 37 and full, then all four full)
    and chunks of 8 and 64 query rows with pad rows, at zamba2's heads,
    on the contiguous cache: a chunk of 64 is the tensor-core kernel in
    bf16, decode the CUDA-core kernel."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(21)
    hq = hkv = 32
    launches = dict(tfd.LAUNCHES)
    for s in (576, 130):
        k = rng.randn(4, s, hkv, D).astype(np.float32)
        v = rng.randn(4, s, hkv, D).astype(np.float32)
        k, v = _to(cuda_device, dtype, k, v)
        kc, vc, kf, vf = _kv(k, v, dtype, int8)
        for kv_lens in ([0, 1, 37, s], [s] * 4):
            pos = np.full((4, s), -1, np.int32)
            for i, n in enumerate(kv_lens):
                pos[i, :n] = np.arange(n)
            qp = np.maximum(np.asarray(kv_lens) - 1, 0).astype(np.int32)
            q = rng.randn(4, 1, hq, D).astype(np.float32)
            q, qp, pos, kvl = _to(cuda_device, dtype, q, qp, pos,
                                  np.asarray(kv_lens, np.int32))
            out = tops.decode_attention(q, kc, vc, qp, pos, kv_len=kvl)
            _check(out, tref.decode_attention_ref(
                q.float(), kf, vf, qp, pos, kv_len=kvl), dtype)
            if kv_lens[0] == 0:
                assert torch.all(out[0] == 0)
        for c, fills, reals in ((8, [8, s, 48], [8, 4, 5]),
                                (64, [64, s, 104], [64, 9, 61])):
            pos = np.full((3, s), -1, np.int32)
            qp = np.full((3, c), -1, np.int32)
            for i, (n, r) in enumerate(zip(fills, reals)):
                pos[i, :n] = np.arange(n)
                qp[i, :r] = np.arange(n - r, n)
            q = rng.randn(3, c, hq, D).astype(np.float32)
            q, qp, pos, kvl = _to(cuda_device, dtype, q, qp, pos,
                                  np.asarray(fills, np.int32))
            out = tops.chunk_attention(q, _slots(kc, 3), _slots(vc, 3),
                                       qp, pos, kv_len=kvl)
            _check(out, tref.chunk_attention_ref(
                q.float(), kf[:3], vf[:3], qp, pos, kv_len=kvl), dtype)
            assert torch.all(out[1, reals[1]:] == 0)
    assert tfd.LAUNCHES["flash_decode"] == launches["flash_decode"] + 4
    assert tfd.LAUNCHES["flash_chunk_prefill"] == \
        launches["flash_chunk_prefill"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs", [64, 8])
def test_paged_at_d80(cuda_device, dtype, bs):
    """The paged pool at D 80, float and int8 K/V: decode and a chunk of
    64 against the plain paged versions, the live blocks scrambled and
    every block no slot maps poisoned (NaN K/V and scales, valid-looking
    positions), so a read outside the live table shows up."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(22)
    b, hq, hkv, s = 3, 32, 32, 576
    n_tbl = s // bs
    fills = np.asarray([0, 200, 576], np.int32)
    need = [-(-int(n) // bs) for n in fills]
    nb = sum(need) + 2
    order = rng.permutation(nb)
    table = np.full((b, n_tbl), order[-1], np.int32)
    pool_pos = rng.randint(0, 3, (nb, bs)).astype(np.int32)
    nxt = 0
    for i, n in enumerate(fills):
        for j in range(need[i]):
            blk = order[nxt]
            nxt += 1
            table[i, j] = blk
            pool_pos[blk] = -1
            m = min(bs, int(n) - j * bs)
            pool_pos[blk, :m] = np.arange(j * bs, j * bs + m)
    poisoned = order[nxt:]
    k = rng.randn(nb, bs, hkv, D).astype(np.float32)
    v = rng.randn(nb, bs, hkv, D).astype(np.float32)
    q1 = rng.randn(b, 1, hq, D).astype(np.float32)
    qc = rng.randn(b, 64, hq, D).astype(np.float32)
    qpc = np.full((b, 64), -1, np.int32)
    for i, n in enumerate(fills):
        r = min(64, int(n))
        qpc[i, :r] = np.arange(n - r, n)
    k, v, q1, qc, pool_pos, table, fills_t, qpc = _to(
        cuda_device, dtype, k, v, q1, qc, pool_pos, table, fills, qpc)
    qp1 = (fills_t - 1).clamp(min=0)
    for int8 in (False, True):
        kc, vc, kf, vf = _kv(k, v, dtype, int8)
        for leaf in (kc, vc):
            if int8:
                leaf.scale[torch.as_tensor(poisoned)] = float("nan")
            else:
                leaf[torch.as_tensor(poisoned)] = float("nan")
        out = tops.decode_attention(q1, kc, vc, qp1, pool_pos,
                                    kv_len=fills_t, block_table=table)
        _check(out, tref.paged_decode_attention_ref(
            q1.float(), kf, vf, qp1, pool_pos, table, fills_t), dtype)
        assert torch.all(out[0] == 0)
        out = tops.chunk_attention(qc, kc, vc, qpc, pool_pos,
                                   kv_len=fills_t, block_table=table)
        _check(out, tref.paged_chunk_attention_ref(
            qc.float(), kf, vf, qpc, pool_pos, table, fills_t), dtype)
        assert bool(out.isfinite().all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_serving_scale_is_the_real_head_dim(cuda_device, dtype):
    """Two keys whose scores differ by 1 before scaling: the weights of
    their values must be softmax((0, 1) / sqrt(80)), not the padded
    width's 1/sqrt(128)."""
    dtype = DTYPES[dtype]
    q = torch.zeros(1, 1, 1, D, device=cuda_device)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, D, device=cuda_device)
    k[0, 1, 0, 0] = 1.0
    v = torch.zeros(1, 2, 1, D, device=cuda_device)
    v[0, 0, 0, 79] = 1.0
    v[0, 1, 0, 78] = 1.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    pos = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda_device)
    qp = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    out = tops.decode_attention(q, k, v, qp, pos,
                                kv_len=torch.tensor([2], dtype=torch.int32,
                                                    device=cuda_device))
    w = torch.softmax(torch.tensor([0.0, 1.0 / math.sqrt(D)]), 0)
    got = out[0, 0, 0, 78:].float().cpu().flip(0)
    torch.testing.assert_close(got, w, atol=1e-5, rtol=RTOL[dtype])


# name: (B, S, Hq, Hkv, causal, window)
FA_CASES = {
    "causal_zamba2": (1, 300, 32, 32, True, 0),
    "window_64": (2, 200, 4, 2, True, 64),
    "full_ragged": (1, 77, 2, 1, False, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_forward_at_d80(cuda_device, dtype, case):
    """The whole-sequence forward at D 80 (one-shot prefill of zamba2's
    shared block) against the plain version, causal, windowed and full
    over ragged S; its log-sum-exp at the scale 1/sqrt(80) too."""
    dtype = DTYPES[dtype]
    b, s, hq, hkv, causal, window = FA_CASES[case]
    rng = np.random.RandomState(23)
    q, k, v = _to(cuda_device, dtype,
                  *(rng.randn(b, s, h, D).astype(np.float32)
                    for h in (hq, hkv, hkv)))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    _check(out, want, dtype)
    g = hq // hkv
    kr = k.float().repeat_interleave(g, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(D)
    i = torch.arange(s, device=cuda_device)
    ok = torch.ones(s, s, dtype=torch.bool, device=cuda_device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window:
        ok &= i[None, :] > i[:, None] - window
    want_lse = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_backward_d80(cuda_device):
    """The backward at D 80 (once refused, named one for one): zamba2's
    32/32 heads, bf16, causal, against the plain backward within the
    output's rounding plus 2^-10 of each gradient's median (the plain
    backward at the scale 1/sqrt(80))."""
    rng = np.random.RandomState(31)
    q, k, v, do = _to(cuda_device, torch.bfloat16,
                      *(rng.randn(1, 256, 32, D).astype(np.float32)
                        for _ in range(4)))
    out, lse = tfa.flash_attention_fwd(q, k, v)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    want = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        out.float(), do.float())
    for g, w in zip(grads, want):
        assert g.shape[-1] == D and bool(g.isfinite().all())
        lim = 2.0 ** -8 * w.abs() + 2.0 ** -10 * w.abs().median()
        assert bool(((g.float() - w).abs() <= lim).all())
