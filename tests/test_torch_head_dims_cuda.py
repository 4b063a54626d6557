"""The attention kernels at head dims off their tile widths, against their
plain PyTorch versions, on the card: D 16 (every smoke config: d_model 64
over 4 heads) on tiles of 64, D 96 on tiles of 128, D 192 on tiles of
256.  The serving kernels (``flash_decode``, ``flash_chunk_prefill``) on
a contiguous cache and on a paged pool whose unmapped blocks are
poisoned, float and int8 K/V.  Each kernel reads the cache's D real
columns and scales by 1/sqrt(D).  ``flash_attention`` at these head dims:
``tests/test_torch_head_dims_fa_cuda.py``.  Skipped without a GPU
(marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_head_dims_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the checks at
internlm2-1.8b's serving shapes.

Tolerances, as in ``tests/test_torch_d80_cuda.py``: against the plain
version computed in f32 from the same (rounded) inputs, within 1e-5 in
f32 and, in bf16, 1e-5 plus the output's own rounding, 2^-8 of its size.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SERVING_DIMS = (16, 96, 192)
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


def _kv(k, v, dtype, int8):
    """The cache leaves as given or as ``Int8KV``, and what the plain
    version reads: the values dequantized and rounded as the kernel
    rounds them."""
    if not int8:
        return k.clone(), v.clone(), k.float(), v.float()
    kc, vc = tq.quant_kv(k), tq.quant_kv(v)
    return (kc, vc) + tuple(tq.dequant_kv(x, dtype).float()
                            for x in (kc, vc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("d", SERVING_DIMS)
def test_serving_kernels_contiguous(cuda_device, d, int8, dtype):
    """Decode with 4 slots (fills 0, 1, 37 and full) and chunks of 8 and
    64 query rows with pad rows, at internlm2's heads (16 on 8, G 2): a
    chunk of 64 (128 rows a KV head) is the tensor-core kernel in bf16,
    decode the CUDA-core kernel."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(40 + d)
    hq, hkv, s = 16, 8, 576
    before = dict(tfd.LAUNCHES)
    k, v = _to(cuda_device, dtype,
               *(rng.randn(4, s, hkv, d).astype(np.float32)
                 for _ in range(2)))
    kc, vc, kf, vf = _kv(k, v, dtype, int8)
    kv_lens = [0, 1, 37, s]
    pos = np.full((4, s), -1, np.int32)
    for i, n in enumerate(kv_lens):
        pos[i, :n] = np.arange(n)
    qp = np.maximum(np.asarray(kv_lens) - 1, 0).astype(np.int32)
    q = rng.randn(4, 1, hq, d).astype(np.float32)
    q, qp, pos, kvl = _to(cuda_device, dtype, q, qp, pos,
                          np.asarray(kv_lens, np.int32))
    out = tops.decode_attention(q, kc, vc, qp, pos, kv_len=kvl)
    _check(out, tref.decode_attention_ref(q.float(), kf, vf, qp, pos,
                                          kv_len=kvl), dtype, d)
    assert torch.all(out[0] == 0)
    for c, fills, reals in ((8, [8, s, 48], [8, 4, 5]),
                            (64, [64, s, 104], [64, 9, 61])):
        pos = np.full((3, s), -1, np.int32)
        qpc = np.full((3, c), -1, np.int32)
        for i, (n, r) in enumerate(zip(fills, reals)):
            pos[i, :n] = np.arange(n)
            qpc[i, :r] = np.arange(n - r, n)
        q = rng.randn(3, c, hq, d).astype(np.float32)
        q, qpc, pos, kvl = _to(cuda_device, dtype, q, qpc, pos,
                               np.asarray(fills, np.int32))
        k3 = tq.Int8KV(kc.q[:3], kc.scale[:3]) if int8 else kc[:3]
        v3 = tq.Int8KV(vc.q[:3], vc.scale[:3]) if int8 else vc[:3]
        out = tops.chunk_attention(q, k3, v3, qpc, pos, kv_len=kvl)
        _check(out, tref.chunk_attention_ref(q.float(), kf[:3], vf[:3], qpc,
                                             pos, kv_len=kvl), dtype, d)
        assert torch.all(out[1, reals[1]:] == 0)
    assert tfd.LAUNCHES["flash_decode"] == before["flash_decode"] + 1
    assert tfd.LAUNCHES["flash_chunk_prefill"] == \
        before["flash_chunk_prefill"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", SERVING_DIMS)
def test_serving_kernels_paged(cuda_device, d, dtype):
    """The paged pool (blocks of 64), float and int8 K/V: decode and a
    chunk of 64 against the plain paged versions, the live blocks
    scrambled and every block no slot maps poisoned (NaN K/V and scales,
    valid-looking positions), so a read outside the live table shows."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(50 + d)
    b, hq, hkv, s, bs = 3, 16, 8, 576, 64
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
    poisoned = torch.as_tensor(order[nxt:])
    k = rng.randn(nb, bs, hkv, d).astype(np.float32)
    v = rng.randn(nb, bs, hkv, d).astype(np.float32)
    q1 = rng.randn(b, 1, hq, d).astype(np.float32)
    qc = rng.randn(b, 64, hq, d).astype(np.float32)
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
                leaf.scale[poisoned] = float("nan")
            else:
                leaf[poisoned] = float("nan")
        out = tops.decode_attention(q1, kc, vc, qp1, pool_pos,
                                    kv_len=fills_t, block_table=table)
        _check(out, tref.paged_decode_attention_ref(
            q1.float(), kf, vf, qp1, pool_pos, table, fills_t), dtype, d)
        assert torch.all(out[0] == 0)
        out = tops.chunk_attention(qc, kc, vc, qpc, pool_pos,
                                   kv_len=fills_t, block_table=table)
        _check(out, tref.paged_chunk_attention_ref(
            qc.float(), kf, vf, qpc, pool_pos, table, fills_t), dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", SERVING_DIMS)
def test_serving_scale_is_the_real_head_dim(cuda_device, d, dtype):
    """Two keys whose scores differ by 1 before scaling: the weights of
    their values must be softmax((0, 1) / sqrt(D)), not the tile's."""
    dtype = DTYPES[dtype]
    q = torch.zeros(1, 1, 1, d, device=cuda_device)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, d, device=cuda_device)
    k[0, 1, 0, 0] = 1.0
    v = torch.zeros(1, 2, 1, d, device=cuda_device)
    v[0, 0, 0, d - 1] = 1.0
    v[0, 1, 0, d - 2] = 1.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    pos = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda_device)
    qp = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    out = tops.decode_attention(q, k, v, qp, pos,
                                kv_len=torch.tensor([2], dtype=torch.int32,
                                                    device=cuda_device))
    w = torch.softmax(torch.tensor([0.0, 1.0 / math.sqrt(d)]), 0)
    got = out[0, 0, 0, d - 2:].float().cpu().flip(0)
    torch.testing.assert_close(got, w, atol=1e-5, rtol=RTOL[dtype])
