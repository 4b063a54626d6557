"""The port's CUDA kernels against their plain PyTorch versions, on the
card: both attention kernels on the contiguous cache (float or int8 K/V)
and the int8 matmul, bitwise; the paged layouts are in
``tests/test_torch_paged_cuda.py``.  Skipped without a GPU (marker
``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py \
        tests/test_torch_paged_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` repeats the check at
the serving path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import int8_matmul as tim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _decode_case(rng, b, s, hq, hkv, d, kv_lens, pads):
    """Row i holds ``kv_lens[i]`` entries (−1 positions beyond), the first
    ``pads[i]`` of them left-pad (−1); the query sits at the last one."""
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    for i, (n, pad) in enumerate(zip(kv_lens, pads)):
        pos[i, pad:n] = np.arange(n - pad)
    q_pos = np.maximum(np.array(kv_lens) - np.array(pads) - 1, 0) \
        .astype(np.int32)
    return q, k, v, q_pos, pos, np.asarray(kv_lens, np.int32)


def _chunk_case(rng, b, c, s, hq, hkv, d, fills, reals):
    """Row i holds ``fills[i]`` live entries at positions 0..fills−1; the
    chunk's ``reals[i]`` real queries sit at the tail positions, the pad
    query rows beyond at −1."""
    q = rng.randn(b, c, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    qpos = np.full((b, c), -1, np.int32)
    for i, (n, r) in enumerate(zip(fills, reals)):
        pos[i, :n] = np.arange(n)
        qpos[i, :r] = np.arange(n - r, n)
    return q, k, v, qpos, pos, np.asarray(fills, np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("d", [64, 128])
def test_kernels_match_plain_on_card(cuda_device, dtype, rtol, d):
    """Both kernels against the plain versions computed in f32 from the
    same (rounded) inputs, over GQA ratios 1, 2 and 4, capacities 72 and
    130 (no multiple of the tile), empty slots, left pads, pad query rows
    and sliding windows: within 1e-5 in f32; in bf16 within 1e-5 plus
    the output's own rounding, 2^-8 of its size."""
    rng = np.random.RandomState(4)
    launches = dict(tfd.LAUNCHES)
    for hkv, s, window in ((4, 72, 0), (2, 130, 0), (1, 130, 5), (2, 72, 9)):
        arrays = _decode_case(rng, 4, s, 4, hkv, d, kv_lens=[0, 1, s, 37],
                              pads=[0, 0, 2, 3])
        q, k, v, qp, pos, kvl = (torch.from_numpy(a).to(cuda_device)
                                 for a in arrays)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        out = tops.decode_attention(q, k, v, qp, pos, window=window,
                                    kv_len=kvl)
        want = tref.decode_attention_ref(q.float(), k.float(), v.float(), qp,
                                         pos, window=window, kv_len=kvl)
        torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=rtol)
        assert torch.all(out[0] == 0)

        arrays = _chunk_case(rng, 3, 24, s, 4, hkv, d, fills=[24, s, 40],
                             reals=[24, 4, 17])
        q, k, v, qp, pos, kvl = (torch.from_numpy(a).to(cuda_device)
                                 for a in arrays)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        out = tops.chunk_attention(q, k, v, qp, pos, window=window,
                                   kv_len=kvl)
        want = tref.chunk_attention_ref(q.float(), k.float(), v.float(), qp,
                                        pos, window=window, kv_len=kvl)
        torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=rtol)
        assert torch.all(out[1, 4:] == 0)
    assert tfd.LAUNCHES["flash_decode"] == launches["flash_decode"] + 4
    assert tfd.LAUNCHES["flash_chunk_prefill"] == \
        launches["flash_chunk_prefill"] + 4


def _dequant_rounded(kq, ks, dtype):
    """The kernel's int8 dequant: value * scale in f32, rounded once to
    the working dtype, as f32."""
    return (kq.float() * ks[..., None]).to(dtype).float()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (64, 2048, 1024),
                                   (4, 8192, 2048), (5, 200, 300),
                                   (1, 7, 1), (33, 1040, 65)])
def test_int8_matmul_bitwise_on_card(cuda_device, m, k, n):
    """int8_matmul against its plain version (exact float64 sum on the
    card): bitwise equal, ragged M, K and N included."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    x = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=cuda_device) * 0.1 + 1e-3
    ws = torch.rand(n, generator=gen, device=cuda_device) * 0.1 + 1e-3
    before = tim.LAUNCHES["int8_matmul"]
    out = tops.int8_matmul(x, w, xs, ws)
    assert tim.LAUNCHES["int8_matmul"] == before + 1
    want = tref.int8_matmul_ref(x, w, xs, ws)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_kernels_match_plain_on_card(cuda_device, dtype, rtol, d):
    """Both kernels on a contiguous int8 cache (a layer slice of a stacked
    (L, B, S, Hkv, D) cache, so the slot stride is not the dense one)
    against the plain version in f32 on the kernel's dequantized values,
    at capacities 576 and 555, kv_len {0, 1, 37, S} and 20 pad rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    for s in (576, 555):
        kq = torch.randint(-127, 128, (2, 4, s, 2, d), generator=gen,
                           device=cuda_device, dtype=torch.int8)[1]
        vq = torch.randint(-127, 128, (2, 4, s, 2, d), generator=gen,
                           device=cuda_device, dtype=torch.int8)[0]
        ks = torch.rand(4, s, 2, generator=gen, device=cuda_device) * 0.02
        vs = torch.rand(4, s, 2, generator=gen, device=cuda_device) * 0.02
        kc, vc = tq.Int8KV(kq, ks), tq.Int8KV(vq, vs)
        kf, vf = _dequant_rounded(kq, ks, dtype), _dequant_rounded(vq, vs,
                                                                   dtype)
        pos = torch.arange(s, dtype=torch.int32,
                           device=cuda_device).repeat(4, 1)
        kvl = torch.tensor([0, 1, 37, s], dtype=torch.int32,
                           device=cuda_device)
        q = torch.randn(4, 1, 4, d, generator=gen,
                        device=cuda_device).to(dtype)
        qp = (kvl - 1).clamp(min=0)
        out = tops.decode_attention(q, kc, vc, qp, pos, kv_len=kvl)
        want = tref.decode_attention_ref(q.float(), kf, vf, qp, pos,
                                         kv_len=kvl)
        torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=rtol)
        assert torch.all(out[0] == 0)
        qc = torch.randn(4, 64, 4, d, generator=gen,
                         device=cuda_device).to(dtype)
        qpc = torch.full((4, 64), -1, dtype=torch.int32, device=cuda_device)
        qpc[:, :44] = torch.arange(44, dtype=torch.int32,
                                   device=cuda_device) + 300
        out = tops.chunk_attention(qc, kc, vc, qpc, pos,
                                   kv_len=torch.full_like(kvl, 364))
        want = tref.chunk_attention_ref(qc.float(), kf, vf, qpc, pos,
                                        kv_len=torch.full_like(kvl, 364))
        torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=rtol)
        assert torch.all(out[:, 44:] == 0)


@pytest.mark.cuda
def test_quantizers_bitwise_card_vs_cpu(cuda_device):
    """The quantizers give the same int8 values and scales on the card as
    on the CPU (where they are bitwise the JAX package's): every scale is
    one correctly rounded f32 division on both devices."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(64, 2048, generator=gen) * 3
    x[0] = 0.0
    w = torch.randn(3, 3, 16, 64, generator=gen)
    for fn, arg in ((tq.quant_dynamic, x), (tq.quant_kv, x.reshape(64, 16,
                                                                   128)),
                    (tq._leaf_qtensor, x.reshape(4, 512, 64))):
        for got, want in zip(fn(arg.to(cuda_device)), fn(arg)):
            if want is None:            # a QTensor's amax: none attached
                assert got is None
            else:
                assert torch.equal(got.cpu(), want)
    tree = {"w": w, "b": torch.zeros(64), "blocks": [{"w": x[:, :256]}]}
    card = tq.quantize_params({"w": w.to(cuda_device),
                               "b": torch.zeros(64, device=cuda_device),
                               "blocks": [{"w": x[:, :256].to(cuda_device)}]})
    host = tq.quantize_params(tree)
    assert card.meta == host.meta
    for part in ("q", "scales"):
        a, b = getattr(card, part), getattr(host, part)
        assert torch.equal(a["w"].cpu(), b["w"])
        assert torch.equal(a["blocks"][0]["w"].cpu(), b["blocks"][0]["w"])
    assert card.scales["b"] is None and torch.equal(card.q["b"].cpu(),
                                                    host.q["b"])
