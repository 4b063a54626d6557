"""The attention kernels at the shapes of the sliding-window and GQA
configs, against their plain PyTorch versions, on the card: the serving
kernels (``flash_decode``, ``flash_chunk_prefill``) at head dim 256
(gemma3: G 2), on a contiguous cache, a paged pool and the ring layout
``[ring ∥ chunk]`` whose positions are out of index order, float and
int8; the serving kernels at G 3 and G 4 (llama3.2, granite: D 128); and
``flash_attention``'s forward at D 256, causal, windowed and full, and
its backward.  Skipped without a GPU (marker ``cuda``); run
there with

    python -m pytest -q -m cuda tests/test_torch_d256_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the checks at
the serving and prefill paths' full shapes.

Tolerances, as in ``tests/test_torch_kernels_cuda.py``: against the plain
version computed in f32 from the same (rounded) inputs, within 1e-5 in
f32 and, in bf16, 1e-5 plus the output's own rounding, 2^-8 of its size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


def _chunk_case(rng, b, c, s, hq, hkv, d, fills, reals):
    """Row i holds ``fills[i]`` live entries at positions 0..fills−1; the
    chunk's ``reals[i]`` real queries sit at the tail positions, the pad
    rows beyond at −1."""
    q = rng.randn(b, c, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    qpos = np.full((b, c), -1, np.int32)
    for i, (n, r) in enumerate(zip(fills, reals)):
        pos[i, :n] = np.arange(n)
        qpos[i, :r] = np.arange(n - r, n)
    return q, k, v, qpos, pos, np.asarray(fills, np.int32)


def _ring_case(rng, b, w, c, hq, hkv, d, last, reals):
    """The chunk layer's ring layout: a ring of ``w`` rows holding row i's
    positions ``max(0, last[i] − w + 1) .. last[i]`` at ``pos % w`` (the
    rest −1), then the chunk's ``c`` entries at ``last + 1 ..`` (the first
    ``reals[i]`` real, the pad tail −1), concatenated: positions out of
    index order, as ``layers._ring_chunk`` hands them to the kernel."""
    q = rng.randn(b, c, hq, d).astype(np.float32)
    k = rng.randn(b, w + c, hkv, d).astype(np.float32)
    v = rng.randn(b, w + c, hkv, d).astype(np.float32)
    pos = np.full((b, w + c), -1, np.int32)
    qpos = np.full((b, c), -1, np.int32)
    for i, (p, r) in enumerate(zip(last, reals)):
        held = np.arange(max(0, p - w + 1), p + 1)
        pos[i, held % w] = held
        qpos[i, :r] = np.arange(p + 1, p + 1 + r)
        pos[i, w:w + c] = qpos[i]
    return q, k, v, qpos, pos


def _check(out, want, dtype):
    torch.testing.assert_close(out.float(), want, atol=1e-5,
                               rtol=RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_serving_kernels_at_d256(cuda_device, dtype):
    """Decode (G 2, gemma3's heads; and G 1) and chunks of 8 and 64 query
    positions at D 256 on the contiguous cache, with empty slots, windows
    and pad rows; a chunk of 64 at G 2 is 128 rows, the tensor-core
    kernel in bf16."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(11)
    launches = dict(tfd.LAUNCHES)
    for hq, hkv, s, window in ((8, 4, 300, 0), (4, 4, 130, 0),
                               (8, 4, 1100, 1024), (4, 2, 200, 37)):
        kv_lens = [0, 1, s, s // 2 + 7]
        q = rng.randn(4, 1, hq, 256).astype(np.float32)
        k = rng.randn(4, s, hkv, 256).astype(np.float32)
        v = rng.randn(4, s, hkv, 256).astype(np.float32)
        pos = np.full((4, s), -1, np.int32)
        for i, n in enumerate(kv_lens):
            pos[i, :n] = np.arange(n)
        qp = np.maximum(np.asarray(kv_lens) - 1, 0).astype(np.int32)
        q, k, v, qp, pos, kvl = _to(cuda_device, dtype, q, k, v, qp, pos,
                                    np.asarray(kv_lens, np.int32))
        out = tops.decode_attention(q, k, v, qp, pos, window=window,
                                    kv_len=kvl)
        _check(out, tref.decode_attention_ref(
            q.float(), k.float(), v.float(), qp, pos, window=window,
            kv_len=kvl), dtype)
        assert torch.all(out[0] == 0)
        for c in (8, 64):
            arrays = _chunk_case(rng, 3, c, s, hq, hkv, 256,
                                 fills=[c, s, c + 40], reals=[c, 4, c - 3])
            q, k, v, qp, pos, kvl = _to(cuda_device, dtype, *arrays)
            out = tops.chunk_attention(q, k, v, qp, pos, window=window,
                                       kv_len=kvl)
            _check(out, tref.chunk_attention_ref(
                q.float(), k.float(), v.float(), qp, pos, window=window,
                kv_len=kvl), dtype)
            assert torch.all(out[1, 4:] == 0)
    assert tfd.LAUNCHES["flash_decode"] == launches["flash_decode"] + 4
    assert tfd.LAUNCHES["flash_chunk_prefill"] == \
        launches["flash_chunk_prefill"] + 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_ring_concat_at_d256(cuda_device, dtype, int8):
    """The ring branch's call: a chunk against ``[ring ∥ chunk]`` with
    positions out of index order and a window of the ring's size, at
    gemma3's heads (G 2, D 256), a ring that has wrapped, one that has not
    filled and a ragged final chunk; float K/V or ``Int8KV``."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(12)
    for w, c, last, reals in ((1024, 64, [1500, 300], [64, 17]),
                              (64, 16, [70, 5], [16, 16])):
        q, k, v, qp, pos = _ring_case(rng, 2, w, c, 8, 4, 256, last, reals)
        q, k, v, qp, pos = _to(cuda_device, dtype, q, k, v, qp, pos)
        if int8:
            kc, vc = tq.quant_kv(k), tq.quant_kv(v)
            kf, vf = (tq.dequant_kv(x, dtype).float() for x in (kc, vc))
        else:
            kc, vc, kf, vf = k, v, k.float(), v.float()
        out = tops.chunk_attention(q, kc, vc, qp, pos, window=w)
        _check(out, tref.chunk_attention_ref(q.float(), kf, vf, qp, pos,
                                             window=w), dtype)
        assert torch.all(out[1, reals[1]:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_and_int8_at_d256(cuda_device, dtype):
    """The paged pool (blocks of 64) and int8 K/V at D 256: decode and a
    chunk of 64 at G 2 against the plain paged versions."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(13)
    b, hq, hkv, d, bs, n_tbl = 3, 8, 4, 256, 64, 5
    nb = b * n_tbl + 2
    k = rng.randn(nb, bs, hkv, d).astype(np.float32)
    v = rng.randn(nb, bs, hkv, d).astype(np.float32)
    table = rng.permutation(nb)[:b * n_tbl].reshape(b, n_tbl) \
        .astype(np.int32)
    fills = np.asarray([0, 200, 320], np.int32)
    pool_pos = np.full((nb, bs), -1, np.int32)
    for i, n in enumerate(fills):
        for j in range(n):
            pool_pos[table[i, j // bs], j % bs] = j
    q1 = rng.randn(b, 1, hq, d).astype(np.float32)
    qc = rng.randn(b, 64, hq, d).astype(np.float32)
    qpc = np.stack([np.arange(n - 64, n) if n >= 64 else np.full(64, -1)
                    for n in fills]).astype(np.int32)
    k, v, q1, qc, pool_pos, table, fills_t, qpc = _to(
        cuda_device, dtype, k, v, q1, qc, pool_pos, table, fills, qpc)
    qp1 = (fills_t - 1).clamp(min=0)
    for int8 in (False, True):
        if int8:
            kc, vc = tq.quant_kv(k), tq.quant_kv(v)
            kf, vf = (tq.dequant_kv(x, dtype).float() for x in (kc, vc))
        else:
            kc, vc, kf, vf = k, v, k.float(), v.float()
        out = tops.decode_attention(q1, kc, vc, qp1, pool_pos, kv_len=fills_t,
                                    block_table=table)
        _check(out, tref.paged_decode_attention_ref(
            q1.float(), kf, vf, qp1, pool_pos, table, fills_t), dtype)
        out = tops.chunk_attention(qc, kc, vc, qpc, pool_pos, kv_len=fills_t,
                                   block_table=table)
        _check(out, tref.paged_chunk_attention_ref(
            qc.float(), kf, vf, qpc, pool_pos, table, fills_t), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g", [3, 4])
def test_serving_kernels_at_g3_g4(cuda_device, dtype, g):
    """llama3.2-3b (G 3) and granite-3-8b (G 4) at D 128: decode (3 or 4
    query rows a KV head) and chunks of 64 (192 or 256 rows: the tensor
    cores' row tiles of 64, 32 or 16 in bf16), float and int8 K/V."""
    dtype = DTYPES[dtype]
    rng = np.random.RandomState(14 + g)
    hkv = 8
    hq = g * hkv
    for s in (576, 130):
        kv_lens = [0, 1, s, 77]
        q = rng.randn(4, 1, hq, 128).astype(np.float32)
        k = rng.randn(4, s, hkv, 128).astype(np.float32)
        v = rng.randn(4, s, hkv, 128).astype(np.float32)
        pos = np.full((4, s), -1, np.int32)
        for i, n in enumerate(kv_lens):
            pos[i, :n] = np.arange(n)
        qp = np.maximum(np.asarray(kv_lens) - 1, 0).astype(np.int32)
        q, k, v, qp, pos, kvl = _to(cuda_device, dtype, q, k, v, qp, pos,
                                    np.asarray(kv_lens, np.int32))
        arrays = _chunk_case(rng, 2, 64, s, hq, hkv, 128, fills=[s, 64],
                             reals=[64, 9])
        qc, kc_, vc_, qpc, posc, kvlc = _to(cuda_device, dtype, *arrays)
        for int8 in (False, True):
            if int8:
                kd, vd = tq.quant_kv(k), tq.quant_kv(v)
                kf, vf = (tq.dequant_kv(x, dtype).float() for x in (kd, vd))
                kcd, vcd = tq.quant_kv(kc_), tq.quant_kv(vc_)
                kcf, vcf = (tq.dequant_kv(x, dtype).float()
                            for x in (kcd, vcd))
            else:
                kd, vd, kf, vf = k, v, k.float(), v.float()
                kcd, vcd, kcf, vcf = kc_, vc_, kc_.float(), vc_.float()
            out = tops.decode_attention(q, kd, vd, qp, pos, kv_len=kvl)
            _check(out, tref.decode_attention_ref(q.float(), kf, vf, qp,
                                                  pos, kv_len=kvl), dtype)
            assert torch.all(out[0] == 0)
            out = tops.chunk_attention(qc, kcd, vcd, qpc, posc, kv_len=kvlc)
            _check(out, tref.chunk_attention_ref(qc.float(), kcf, vcf, qpc,
                                                 posc, kv_len=kvlc), dtype)
            assert torch.all(out[1, 9:] == 0)


# name: (B, S, Hq, Hkv, causal, window)
FA_CASES = {
    "causal": (1, 300, 8, 4, True, 0),
    "window_64": (2, 200, 4, 2, True, 64),
    "full_ragged": (1, 77, 2, 1, False, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_forward_at_d256(cuda_device, dtype, case):
    """The whole-sequence forward at D 256 (one-shot prefill of gemma3)
    against the plain version, causal, windowed (the local layers) and
    full over ragged S; its log-sum-exp too."""
    dtype = DTYPES[dtype]
    b, s, hq, hkv, causal, window = FA_CASES[case]
    rng = np.random.RandomState(15)
    q, k, v = _to(cuda_device, dtype,
                  *(rng.randn(b, s, h, 256).astype(np.float32)
                    for h in (hq, hkv, hkv)))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    _check(out, want, dtype)
    g = hq // hkv
    kr, qr = k.float().repeat_interleave(g, 2), q.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", qr, kr) / 16.0
    i = torch.arange(s, device=cuda_device)
    ok = torch.ones(s, s, dtype=torch.bool, device=cuda_device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window:
        ok &= i[None, :] > i[:, None] - window
    want_lse = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_backward_d256(cuda_device):
    """The backward at D 256 (once refused, named one for one): gemma3's
    8/4 heads, bf16, causal and with its window, two blocks a head each
    with half of the columns, against the plain backward within the
    output's rounding plus 2^-10 of each gradient's median."""
    rng = np.random.RandomState(37)
    for window in (0, 96):
        q, do = (torch.from_numpy(rng.randn(1, 300, 8, 256)
                                  .astype(np.float32))
                 .to(cuda_device, torch.bfloat16) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(1, 300, 4, 256)
                                 .astype(np.float32))
                .to(cuda_device, torch.bfloat16) for _ in range(2))
        out, lse = tfa.flash_attention_fwd(q, k, v, window=window)
        grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
        want = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                            out.float(), do.float(), True,
                                            window)
        for g, w in zip(grads, want):
            assert g.shape[-1] == 256 and bool(g.isfinite().all())
            lim = 2.0 ** -8 * w.abs() + 2.0 ** -10 * w.abs().median()
            assert bool(((g.float() - w).abs() <= lim).all())
