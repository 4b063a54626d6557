"""The port's attention kernels on the paged KV pool, float or int8,
against their plain PyTorch versions, on the card.  Skipped without a GPU
(marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_paged_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.
"""
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dequant_rounded(kq, ks, dtype):
    """The kernel's int8 dequant: value * scale in f32, rounded once to
    the working dtype, as f32."""
    return (kq.float() * ks[..., None]).to(dtype).float()


def _paged_case(gen, dev, b, c, bs, n_tbl, hkv, g, d, fills, reals, dtype,
                int8):
    """A scrambled pool: slot i's live blocks are a random set of pool
    blocks; the unmapped blocks hold NaN (K/V values, or int8 scales) and
    valid-looking positions, and every table entry past a slot's live
    blocks names one of them: a read outside the live table is NaN."""
    need = [-(-f // bs) for f in fills]
    nb = sum(need) + 3
    order = torch.randperm(nb, generator=gen, device=dev)
    k = torch.randn(nb, bs, hkv, d, generator=gen, device=dev)
    v = torch.randn(nb, bs, hkv, d, generator=gen, device=dev)
    pos = torch.randint(0, 3, (nb, bs), generator=gen, device=dev,
                        dtype=torch.int32)
    table = torch.zeros(b, n_tbl, dtype=torch.int32, device=dev)
    mapped = []
    nxt = 0
    for i, f in enumerate(fills):
        for j in range(need[i]):
            blk = int(order[nxt])
            nxt += 1
            mapped.append(blk)
            table[i, j] = blk
            n = min(bs, f - j * bs)
            pos[blk, :n] = torch.arange(j * bs, j * bs + n, device=dev,
                                        dtype=torch.int32)
            pos[blk, n:] = -1
        table[i, need[i]:] = int(order[-1])
    unmapped = [x for x in range(nb) if x not in mapped]
    ks = vs = None
    if int8:
        k = torch.randint(-127, 128, k.shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, v.shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(nb, bs, hkv, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(nb, bs, hkv, generator=gen, device=dev) * 0.02 + 1e-3
        ks[unmapped] = float("nan")
        vs[unmapped] = float("nan")
    else:
        k, v = k.to(dtype), v.to(dtype)
        k[unmapped] = float("nan")
        v[unmapped] = float("nan")
    q = torch.randn(b, c, hkv * g, d, generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    for i, (f, r) in enumerate(zip(fills, reals)):
        qpos[i, :r] = torch.arange(f - r, f, dtype=torch.int32, device=dev)
    kvl = torch.tensor(fills, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, qpos, pos, table, kvl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 64])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernels_match_plain_on_card(cuda_device, dtype, rtol, d, bs,
                                           int8):
    """Both kernels on a paged pool (float or int8) against the plain
    gather-through-the-table version computed in f32 from the same inputs
    (int8 dequantized and rounded as the kernel rounds): GQA 2, pages of
    8, 16 and 64 entries (a 64-entry tile spans several small pages),
    scrambled tables, poisoned unmapped blocks, kv_len {0, 1, 37, S},
    and a chunk with 20 pad rows.  Tolerance as for the float layouts."""
    gen = torch.Generator(device=cuda_device).manual_seed(bs + d)
    n_tbl = 192 // bs
    s = n_tbl * bs
    for c, fills, reals in ((1, [0, 1, 37, s], [0, 1, 1, 1]),
                            (64, [100, s], [44, 64])):
        q, k, v, ks, vs, qpos, pos, table, kvl = _paged_case(
            gen, cuda_device, len(fills), c, bs, n_tbl, 2, 2, d, fills,
            reals, dtype, int8)
        kc = tq.Int8KV(k, ks) if int8 else k
        vc = tq.Int8KV(v, vs) if int8 else v
        kf = _dequant_rounded(k, ks, dtype) if int8 else k.float()
        vf = _dequant_rounded(v, vs, dtype) if int8 else v.float()
        if c == 1:
            out = tops.decode_attention(q, kc, vc, qpos[:, 0], pos,
                                        kv_len=kvl, block_table=table)
            want = tref.paged_decode_attention_ref(
                q.float(), kf, vf, qpos[:, 0], pos, table, kvl)
        else:
            out = tops.chunk_attention(q, kc, vc, qpos, pos, kv_len=kvl,
                                       block_table=table)
            want = tref.paged_chunk_attention_ref(
                q.float(), kf, vf, qpos, pos, table, kvl)
        assert out.dtype == dtype
        torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=rtol)
        if c == 1:
            assert torch.all(out[0] == 0)
        else:
            assert torch.all(out[0, 44:] == 0)
