"""The MoE decoders' path on the card.  Skipped without a GPU (marker
``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

- Both serving kernels at the MoE decoders' head groups, D 128: G 6
  (dbrx-132b: 48 query heads over 8 KV heads; a chunk of 64 is 384 rows a
  KV head) and G 4 (phi3.5-moe), decode and a chunk with pad rows, on the
  contiguous cache and a paged pool, float and int8 K/V, bf16 and f32,
  against their plain versions (f32: 1e-5; bf16: 1e-5 plus the output's
  own rounding, 2^-8 of its size).
- ``moe_layer`` on the card against the CPU in f32 with planted ties
  (equal router columns, all-zero tokens) and an expert that overflows:
  the routing bit for bit (the logits are exact sums), the output within
  1e-5 (TF32 off).
- The smoke MoE decode step (a float32 config at head dim 128) exported
  and captured as a CUDA graph: the engine served from it gives the
  eager engine's tokens, and every decode step is a replay.

This file imports neither JAX nor the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import eon_compiler as eon
from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models.params import init_params
from repro_torch.serve.server import ContinuousBatchServer, PagedBatchServer

D = 128
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, want, dtype):
    torch.testing.assert_close(out.float(), want, atol=1e-5,
                               rtol=RTOL[dtype])


def _kv(k, v, dtype, int8):
    """The cache leaves as given or as ``Int8KV``, and what the plain
    version reads (dequantized and rounded as the kernel rounds)."""
    if not int8:
        return k, v, k.float(), v.float()
    kc, vc = tq.quant_kv(k), tq.quant_kv(v)
    return (kc, vc) + tuple(tq.dequant_kv(x, dtype).float()
                            for x in (kc, vc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g", [6, 4])
def test_serving_kernels_at_moe_groups(cuda_device, dtype, g):
    """Decode over 4 slots (fills 0, 1, 37 and 576) and a chunk of 64
    with 20 pad rows (fill 448), contiguous, then on a paged pool of
    blocks of 64 in a scrambled table; float and int8 K/V."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(30 + g)
    hkv, s, bs = 8, 576, 64
    hq = hkv * g
    fills = torch.tensor([0, 1, 37, s], dtype=torch.int32,
                         device=cuda_device)
    pos = torch.full((4, s), -1, dtype=torch.int32, device=cuda_device)
    for i, n in enumerate(fills.tolist()):
        pos[i, :n] = torch.arange(n, dtype=torch.int32)
    k = torch.randn(4, s, hkv, D, generator=gen, device=cuda_device)
    v = torch.randn(4, s, hkv, D, generator=gen, device=cuda_device)
    k, v = k.to(dtype), v.to(dtype)
    q1 = torch.randn(4, 1, hq, D, generator=gen, device=cuda_device) \
        .to(dtype)
    qc = torch.randn(1, 64, hq, D, generator=gen, device=cuda_device) \
        .to(dtype)
    qpc = torch.full((1, 64), -1, dtype=torch.int32, device=cuda_device)
    qpc[0, :44] = torch.arange(404, 448, dtype=torch.int32)
    fill_c = torch.tensor([448], dtype=torch.int32, device=cuda_device)
    qp1 = (fills - 1).clamp(min=0)
    # the paged pool: slot i's block j at a scrambled pool block
    n_tbl = s // bs
    table = torch.randperm(4 * n_tbl, generator=gen, device=cuda_device) \
        .to(torch.int32).reshape(4, n_tbl)
    pk = torch.empty(4 * n_tbl, bs, hkv, D, dtype=dtype, device=cuda_device)
    pv = torch.empty_like(pk)
    ppos = torch.empty(4 * n_tbl, bs, dtype=torch.int32, device=cuda_device)
    flat = table.reshape(-1).long()
    pk[flat] = k.reshape(4 * n_tbl, bs, hkv, D)
    pv[flat] = v.reshape(4 * n_tbl, bs, hkv, D)
    ppos[flat] = pos.reshape(4 * n_tbl, bs)
    before = dict(tfd.LAUNCHES)
    for int8 in (False, True):
        kc, vc, kf, vf = _kv(k, v, dtype, int8)
        out = tops.decode_attention(q1, kc, vc, qp1, pos, kv_len=fills)
        _check(out, tref.decode_attention_ref(q1.float(), kf, vf, qp1, pos,
                                              kv_len=fills), dtype)
        assert torch.all(out[0] == 0)
        sl = (lambda t: tq.Int8KV(t.q[3:], t.scale[3:])) if int8 else \
            (lambda t: t[3:])
        out = tops.chunk_attention(qc, sl(kc), sl(vc), qpc, pos[3:],
                                   kv_len=fill_c)
        _check(out, tref.chunk_attention_ref(qc.float(), kf[3:], vf[3:],
                                             qpc, pos[3:], kv_len=fill_c),
               dtype)
        assert torch.all(out[0, 44:] == 0)
        pkc, pvc, pkf, pvf = _kv(pk, pv, dtype, int8)
        out = tops.decode_attention(q1, pkc, pvc, qp1, ppos, kv_len=fills,
                                    block_table=table)
        _check(out, tref.paged_decode_attention_ref(
            q1.float(), pkf, pvf, qp1, ppos, table, fills), dtype)
        out = tops.chunk_attention(qc, pkc, pvc, qpc, ppos, kv_len=fill_c,
                                   block_table=table[3:])
        _check(out, tref.paged_chunk_attention_ref(
            qc.float(), pkf, pvf, qpc, ppos, table[3:], fill_c), dtype)
    assert tfd.LAUNCHES["flash_decode"] == before["flash_decode"] + 4
    assert tfd.LAUNCHES["flash_chunk_prefill"] == \
        before["flash_chunk_prefill"] + 4


def _exact_inputs(rng, t, e, d, f):
    """Integer tokens, a router in multiples of 1/8 with columns 1 and
    E - 1 equal, all-zero tokens every 11th, and column 0 skewed so that
    expert 0 overflows."""
    x = rng.randint(-2, 3, (t, d)).astype(np.float32)
    x[:, 0] = 1.0
    x[3::11] = 0.0
    router = rng.randint(-2, 3, (d, e)).astype(np.float32) / 8
    router[:, -1] = router[:, 1]
    router[0, 0] += 16.0
    p = {"router": router,
         "w_gate": rng.randn(e, d, f).astype(np.float32) * 0.1,
         "w_up": rng.randn(e, d, f).astype(np.float32) * 0.1,
         "w_down": rng.randn(e, f, d).astype(np.float32) * 0.1}
    return x, p


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_moe_layer_on_card_matches_cpu(cuda_device, k):
    """T 160 (2 x 80), E 16 wide as the full configs, k 2 and 4: the
    same rows kept and dropped on the card as on the CPU, the output
    within 1e-5."""
    cfg = dataclasses.replace(configs.get_smoke("dbrx-132b"),
                              n_experts=16, experts_per_tok=k,
                              dtype="float32")
    rng = np.random.RandomState(k)
    x, p = _exact_inputs(rng, 160, 16, cfg.d_model, cfg.d_ff)
    host = {n: torch.from_numpy(v) for n, v in p.items()}
    card = {n: v.to(cuda_device) for n, v in host.items()}
    xh = torch.from_numpy(x)
    xc = xh.to(cuda_device)
    cap = tmoe.moe_capacity(cfg, 160)
    want = tmoe._dispatch_indices(xh @ host["router"], k, 16, cap)
    got = tmoe._dispatch_indices(xc @ card["router"], k, 16, cap)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    assert int((~want[2]).sum()) > 0
    out = tmoe.moe_layer(card, xc.reshape(2, 80, -1), cfg)
    ref = tmoe.moe_layer(host, xh.reshape(2, 80, -1), cfg)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)


def _small(arch):
    """The smoke config in float32 at head dim 128 (the kernels' least),
    with the full config's head group: G 4 (phi3.5-moe), G 6 (dbrx)."""
    g = 6 if arch == "dbrx-132b" else 4
    return dataclasses.replace(configs.get_smoke(arch), d_model=256,
                               n_heads=g, n_kv_heads=1, head_dim=128,
                               dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "dbrx-132b"])
@pytest.mark.parametrize("engine", [ContinuousBatchServer, PagedBatchServer],
                         ids=["continuous", "paged"])
def test_moe_decode_graph_replays_the_eager_tokens(cuda_device, arch,
                                                   engine):
    """The decode step with its routing (stable sort, cumsum, scatter and
    gather over the (E, capacity + 1, d) buffer) captured as a CUDA graph
    at construction: the tokens of the eager engine, one replay a decode
    step."""
    cfg = _small(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 9, 30)]
    runs = []
    for use_artifact in (False, True):
        srv = engine(cfg, params, slots=2, max_prompt=32, prefill_chunk=8,
                     max_new_tokens=6, device="cuda",
                     use_artifact=use_artifact)
        reqs = srv.submit(prompts)
        metrics = srv.run()
        runs.append(([r.tokens for r in reqs], metrics, srv))
    (etok, em, _), (atok, am, srv) = runs
    assert atok == etok
    assert isinstance(srv.decode, eon.GraphStep)
    assert srv.decode.replays == am["decode_steps"] == em["decode_steps"]
