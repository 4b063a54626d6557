"""The serving attention kernels with the KV sweep split over a cluster
(``csrc/flash_decode.cu``), against their plain PyTorch versions, on the
card.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_flash_decode_split_cuda.py

Both kernels (``simt_attn_kernel`` for decode and every f32 call,
``mma_attn_kernel`` for bf16 chunks) in all four layouts (float or int8
K/V, contiguous or paged) at D 64 and 128, at capacities whose launch
plan splits each slot's sweep over 1, 2, 4 and 8 blocks (each test
asserts the split it reaches), with kv_len 0 and 1 in the same batch.
Rows past a slot's kv_len hold NaN (values, or int8 scales), and a paged
table's entries past the live blocks name a NaN block, so a read outside
the live entries shows.  Tolerance: phase 2's, the bf16 output's own
rounding (2^-8 of each value) plus 1e-5, f32 1e-5.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.
"""
import pytest
import torch

from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}
# layout: (int8 K/V, paged)
LAYOUTS = {"float": (False, False), "int8": (True, False),
           "paged": (False, True), "int8_paged": (True, True)}
# split: capacity S that gives it (decode: 16-entry tiles; chunk: 64)
DECODE_S = {1: 16, 2: 32, 4: 64, 8: 576}
CHUNK_S = {1: 64, 2: 128, 4: 256, 8: 576}
HKV, G = 2, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(gen, dev, layout, b, c, s, hkv, d, fills, reals, dtype):
    """q, the caches (tensors or ``Int8KV``), query positions, positions,
    kv_len, the block table (None when contiguous) and K/V in f32 as the
    kernels compute with them (int8 dequantized and rounded to dtype).
    Slot i holds ``fills[i]`` entries at positions 0..; its ``reals[i]``
    queries sit at the last of them, pad queries beyond at -1."""
    int8, paged = LAYOUTS[layout]
    bs = (8 if s <= 64 else 64) if paged else None
    if paged:
        need = [-(-f // bs) for f in fills]
        outer, rows = sum(need) + 2, bs
        order = torch.randperm(outer, generator=gen, device=dev).tolist()
        pos = torch.randint(0, 3, (outer, bs), generator=gen, device=dev,
                            dtype=torch.int32)
        table = torch.full((b, s // bs), order[-1], dtype=torch.int32,
                           device=dev)
        nxt = 0
        for i, f in enumerate(fills):
            for j in range(need[i]):
                blk = order[nxt]
                nxt += 1
                table[i, j] = blk
                n = min(bs, f - j * bs)
                pos[blk] = -1
                pos[blk, :n] = torch.arange(j * bs, j * bs + n,
                                            dtype=torch.int32, device=dev)
        dead = torch.zeros(outer, bs, dtype=torch.bool, device=dev)
        dead[order[nxt:]] = True
    else:
        table, outer, rows = None, b, s
        idx = torch.arange(s, device=dev)
        dead = idx[None] >= torch.tensor(fills, device=dev)[:, None]
        pos = torch.where(dead, -1, idx[None]).to(torch.int32)
    shape = (outer, rows, hkv, d)

    def leaf():
        if int8:
            x = torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8)
            sc = torch.rand(shape[:-1], generator=gen, device=dev) \
                * (1.5 / 127) + 0.5 / 127
            f = (x.float() * sc[..., None]).to(dtype).float()
            sc[dead] = float("nan")
            return tq.Int8KV(x, sc), f
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        x[dead] = float("nan")
        return x, x.float()

    (kc, kf), (vc, vf) = leaf(), leaf()
    q = torch.randn(b, c, hkv * G, d, generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    for i, (n, r) in enumerate(zip(fills, reals)):
        qpos[i, :r] = torch.arange(n - r, n, dtype=torch.int32, device=dev)
    kvl = torch.tensor(fills, dtype=torch.int32, device=dev)
    return q, kc, vc, qpos, pos, kvl, table, kf, vf


def _run(kind, case, window=0):
    """The kernel's output and the plain version's, f32 from the same
    inputs."""
    q, kc, vc, qpos, pos, kvl, table, kf, vf = case
    qp = qpos[:, 0] if kind == "decode" else qpos
    kern = tops.decode_attention if kind == "decode" else tops.chunk_attention
    out = kern(q, kc, vc, qp, pos, kv_len=kvl, block_table=table,
               window=window)
    torch.cuda.synchronize()
    if table is None:
        want = getattr(tref, f"{kind}_attention_ref")(
            q.float(), kf, vf, qp, pos, window=window, kv_len=kvl)
    else:
        want = getattr(tref, f"paged_{kind}_attention_ref")(
            q.float(), kf, vf, qp, pos, table, kvl, window=window)
    return out, want


def _assert_within(out, want, dtype):
    rtol, atol = TOL[dtype]
    assert out.dtype == dtype and bool(out.isfinite().all())
    lim = rtol * want.abs() + atol
    assert float(((out.float() - want).abs() / lim).max()) <= 1


def _plan_of(kind, case, s):
    q, kc = case[0], case[1]
    b, c, hq, d = q.shape
    r = G if kind == "decode" else c * G
    return tfd._plan(b, HKV, r, s, q.dtype, isinstance(kc, tq.Int8KV), d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_every_split(cuda_device, layout, d):
    """Decode (G 2, CUDA cores) at splits 1, 2, 4 and 8, bf16 and f32:
    slots at kv_len 0, 1, about half and S; the idle slot gives exact
    zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    for split, s in DECODE_S.items():
        for dtype in (torch.bfloat16, torch.float32):
            fills = [0, 1, s // 2 + 3, s]
            case = _case(gen, cuda_device, layout, 4, 1, s, HKV, d, fills,
                         [0, 1, 1, 1], dtype)
            plan = _plan_of("decode", case, s)
            assert (plan.kernel, plan.split) == ("simt", split)
            out, want = _run("decode", case)
            _assert_within(out, want, dtype)
            assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunk_every_split(cuda_device, layout, d):
    """A chunk of 16 queries (32 rows): bf16 on the tensor cores at splits
    1, 2, 4 and 8, f32 on the CUDA cores; slots at kv_len 0 (all pad), 1
    (one real query), about half and S; pad rows give exact zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(100 + d)
    c = 16
    for split, s in CHUNK_S.items():
        for dtype in (torch.bfloat16, torch.float32):
            fills = [0, 1, s // 2 + 5, s]
            case = _case(gen, cuda_device, layout, 4, c, s, HKV, d, fills,
                         [0, 1, c, c - 3], dtype)
            plan = _plan_of("chunk", case, s)
            if dtype == torch.bfloat16:
                assert (plan.kernel, plan.split) == ("mma", split)
            else:
                assert plan.kernel == "simt"
            out, want = _run("chunk", case)
            _assert_within(out, want, dtype)
            assert bool((out[0] == 0).all()) and bool((out[1, 1:] == 0).all())
            assert bool((out[3, c - 3:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["float", "int8_paged"])
def test_chunk_row_tiles(cuda_device, layout):
    """The tensor-core kernel's three row tiles, 16, 32 and 64 rows a
    block (one, two and four warps), at the serving chunk (64 queries x
    G 2 over 8 KV heads, S 576) and its neighbours."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    seen = set()
    for b, hkv in ((1, 2), (1, 8), (2, 8)):
        fills = [448, 576][:b]
        case = _case(gen, cuda_device, layout, b, 64, 576, hkv, 128, fills,
                     [44, 64][:b], torch.bfloat16)
        q, kc = case[0], case[1]
        plan = tfd._plan(b, hkv, 128, 576, torch.bfloat16,
                         isinstance(kc, tq.Int8KV), 128)
        seen.add(plan.rows)
        out, want = _run("chunk", case)
        _assert_within(out, want, torch.bfloat16)
        assert bool((out[0, 44:] == 0).all())
    assert seen == {16, 32, 64}


@pytest.mark.cuda
def test_window_and_strided_views(cuda_device):
    """A sliding window (48) in both kernels and both dtypes, on K/V that
    are a layer's slice of a stacked cache (an outer stride of two
    slots' worth), with one launch counted a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for kind, c in (("decode", 1), ("chunk", 16)):
        for dtype in (torch.bfloat16, torch.float32):
            s = 192
            case = list(_case(gen, cuda_device, "float", 4, c, s, HKV, 64,
                              [0, 1, 100, s], [0, 1, c, c], dtype))
            for i in (1, 2):   # the cache as a slice of (B, 2, S, Hkv, D)
                big = torch.zeros((4, 2, s, HKV, 64), dtype=dtype,
                                  device=cuda_device)
                big[:, 1] = case[i]
                case[i] = big[:, 1]
            assert case[1].stride(0) == 2 * s * HKV * 64
            before = dict(tfd.LAUNCHES)
            out, want = _run(kind, tuple(case), window=48)
            name = "flash_decode" if kind == "decode" else \
                "flash_chunk_prefill"
            assert tfd.LAUNCHES[name] == before[name] + 1
            _assert_within(out, want, dtype)
