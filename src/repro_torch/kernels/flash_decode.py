"""Flash-decode and chunk-prefill attention over the slot-addressed or
paged KV cache, float or int8: wrappers of the hand-written CUDA kernels
in ``csrc/flash_decode.cu``.

``flash_decode`` replaces ``repro/kernels/flash_decode.py:147`` and
``flash_chunk_prefill`` replaces ``:334``, in all four layouts of the TPU
kernels: K/V float or int8 (``k_scale``/``v_scale`` given), each
contiguous or paged (``block_table`` given).  Each wrapper checks device,
dtype, shape, strides and alignment, plans the launch from the shape
(``_plan``), launches one kernel on PyTorch's current stream and counts
the launch in ``LAUNCHES``.  The plan splits each slot's KV sweep over a
thread-block cluster whose blocks merge their partial softmax states in
distributed shared memory, and picks the kernel: ``simt_attn_kernel``
(CUDA cores, f32) for decode and every float32 call,
``mma_attn_kernel`` (bf16 tensor cores) for bf16 chunks of more than 16
query rows.  They take CUDA tensors only: ``kernels/ops.py`` sends CPU
tensors to the plain versions in ``kernels/ref.py``.

K/V (and their scales) may be per-layer slices of the stacked cache or
one slot's row of it: any stride of the outer (slot or pool-block) axis
is taken, the inner ``(S, Hkv, D)`` layout must be dense.  Nothing here
copies, gathers or dequantizes the cache.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of each kernel since the last reset (the caller resets)
LAUNCHES = {"flash_decode": 0, "flash_chunk_prefill": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tile widths the kernels are built for; a head dim D (a multiple of
# 16 from 16 to 256) is computed on the least that holds it, the columns
# past D zero-filled in shared memory and never written out
TILE_DIMS = (64, 128, 256)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])

# the kernels' constants (csrc/flash_decode.cu): the CUDA-core kernel's
# KV tile, ring depth and most rows a block, the tensor-core kernel's KV
# tile and ring depth, the portable cluster size and the shared memory's
# alignment slack
SIMT_BK = 16
SIMT_STAGES = 4
SIMT_MAX_ROWS = 16
MMA_BK = 64
MMA_STAGES = 2
MAX_SPLIT = 8
SMEM_SLACK = 128
SMS = 132                 # the H100's SMs


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``kernel`` "simt" (CUDA cores) or "mma" (tensor
    cores); ``rows`` query rows a block; KV tiles of ``bk`` entries
    through a ring of ``stages``; each slot's KV sweep split over the
    ``split`` blocks of a cluster; the grid (B, Hkv, row tiles x split)
    and the dynamic shared memory in bytes."""
    kernel: str
    rows: int
    bk: int
    stages: int
    split: int
    grid: Tuple[int, int, int]
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _simt_warps(rows: int) -> int:
    """Warps of a CUDA-core block: eight for 2 or 4 rows (decode), four
    for more."""
    return 8 if rows <= 4 else 4


def check_head_dim(d: int) -> None:
    """Raise unless the kernels take head dim ``d``: a multiple of 16 from
    16 to 256 (whole 16-byte chunks a row in every type)."""
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head_dim {d}: the kernels take a multiple of 16"
                         " from 16 to 256")


def tile_dim(d: int) -> int:
    """The width the kernels compute a row of head dim ``d`` on: the least
    of ``TILE_DIMS`` that holds it."""
    check_head_dim(d)
    return next(t for t in TILE_DIMS if d <= t)


def simt_max_rows(d: int) -> int:
    """Most rows a CUDA-core block takes: 16, or 8 on the tile of 256,
    where 16 rows of 8 columns a lane would hold 256 f32 of q and acc a
    thread."""
    return 8 if tile_dim(d) > 128 else 16


def _smem(kernel: str, rows: int, d: int, kv_bytes: int, int8: bool) -> int:
    """Dynamic shared memory of a launch, as the kernel lays it out: the
    ring (K and V tiles, positions, int8 scales a stage), and after the
    sweep the partial (acc, m, l) of the block's rows; the CUDA-core
    kernel also holds its warps' partials, the tensor-core kernel
    the query tile and, for int8, the dequantized K and V tiles.  Every
    row is ``tile_dim(d)`` wide."""
    d = tile_dim(d)
    bk, stages = (MMA_BK, MMA_STAGES) if kernel == "mma" \
        else (SIMT_BK, SIMT_STAGES)
    ring = stages * (2 * bk * d * kv_bytes + bk * 4 * (3 if int8 else 1))
    part = rows * (d + 2) * 4
    if kernel == "mma":
        need = max(ring + rows * d * 2 + (2 * bk * d * 2 if int8 else 0),
                   part)
    else:
        need = max(ring, (_simt_warps(rows) + 1) * part)
    return need + SMEM_SLACK


@functools.lru_cache(maxsize=None)
def _plan(b: int, hkv: int, r: int, s: int, dtype: torch.dtype, int8: bool,
          d: int = 128) -> Plan:
    """The launch for ``r`` query rows a (slot, KV head) over a cache of
    capacity ``s``, from the host-known shape alone (``kv_len`` lives on
    the card).  bf16 calls of more than 16 rows (chunks) take the
    tensor-core kernel with 64, 32 or 16 rows a block, the most that
    still gives one block an SM at the largest split; the rest take the
    CUDA-core kernel with 2 or 4 rows a block (decode at G <= 2, at G 3
    or 4) or 16 (8 on the tile of 256).  The split is the least power of
    two that gives the grid at least one block an SM, at most 8 (the
    portable cluster size) and at most the KV tiles of a full slot."""
    mma = dtype == torch.bfloat16 and r > SIMT_MAX_ROWS
    bk, stages = (MMA_BK, MMA_STAGES) if mma else (SIMT_BK, SIMT_STAGES)
    max_split = 1
    while max_split < MAX_SPLIT and 2 * max_split <= _cdiv(s, bk):
        max_split *= 2
    if mma:
        rows = 64
        while rows > 16 and b * hkv * _cdiv(r, rows) * max_split < SMS:
            rows //= 2
    else:
        rows = next((n for n in (2, 4) if r <= n), simt_max_rows(d))
    tiles = b * hkv * _cdiv(r, rows)
    split = 1
    while split < max_split and tiles * split < SMS:
        split *= 2
    kv_bytes = 1 if int8 else torch.empty((), dtype=dtype).element_size()
    kernel = "mma" if mma else "simt"
    return Plan(kernel, rows, bk, stages, split,
                (b, hkv, _cdiv(r, rows) * split),
                _smem(kernel, rows, d, kv_bytes, int8))


def _tile_ranges(plan: Plan, kv_len: int, s: int) -> List[Tuple[int, int]]:
    """The KV tiles ``[begin, end)`` that each block of a split sweeps
    for a slot of ``kv_len`` live entries, by rank: the kernel's own rule
    (``Sweep`` in ``csrc/flash_decode.cu``), kv_len clamped to [0, s] and
    its n = ceil(kv_len / bk) tiles dealt out as evenly as whole tiles
    allow; a range may be empty."""
    n = _cdiv(min(max(kv_len, 0), s), plan.bk)
    return [(rank * n // plan.split, (rank + 1) * n // plan.split)
            for rank in range(plan.split)]


def kv_block_size(capacity: int, block_k: int = 128) -> int:
    """KV block granularity at a given per-slot capacity: the TPU kernels'
    tile choice, min(block_k, capacity), halved until it divides capacity
    cleanly (floored at 8).  Shared with the JAX package's serving engines
    (capacity rounding, the paged pool's block size), so it is kept
    identical here."""
    bk = min(block_k, max(int(capacity), 1))
    while capacity % bk and bk > 8:
        bk //= 2
    return bk


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_decode")
    if lib.flash_decode.argtypes is None:
        for fn in (lib.flash_decode, lib.flash_chunk_prefill):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, q_pos, cache_pos, kv_len, q_pos_shape, k_scale,
           v_scale, block_table) -> int:
    """Raise on anything the kernel does not take; returns the logical
    per-slot capacity S (``n_tbl * BS`` for a paged pool)."""
    b, hkv, r, d = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    named = [("k", k), ("v", v), ("q_pos", q_pos), ("cache_pos", cache_pos),
             ("kv_len", kv_len)]
    if int8:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    if block_table is not None:
        named.append(("block_table", block_table))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    kv_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: q"
                        " float32 or bfloat16, K/V of q's dtype, or int8"
                        " with scales")
    check_head_dim(d)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    outer, rows = k.shape[0], k.shape[1]
    if block_table is None:
        if outer != b:
            raise ValueError(f"k has {outer} slots, q {b}")
        s = rows
    else:
        if block_table.dtype != torch.int32 or block_table.dim() != 2 \
                or block_table.shape[0] != b \
                or not block_table.is_contiguous():
            raise ValueError("block_table must be contiguous int32"
                             f" ({b}, n_blocks)")
        if rows < 8:
            raise ValueError(f"pool block of {rows} entries: at least 8")
        s = block_table.shape[1] * rows
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (outer, rows, hkv, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(outer, rows, hkv, d)}")
        if t.stride()[1:] != (hkv * d, d, 1):
            raise ValueError(f"{name} strides {t.stride()}: the inner"
                             " (S, Hkv, D) layout must be dense")
        if (t.stride(0) * t.element_size()) % 16 or t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned per slot or"
                             " block")
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 \
                    or tuple(t.shape) != (outer, rows, hkv) \
                    or t.stride()[1:] != (hkv, 1):
                raise ValueError(f"{name} must be float32 {(outer, rows, hkv)}"
                                 " with a dense (S, Hkv) inner layout")
    for name, t, shape in (("q_pos", q_pos, q_pos_shape),
                           ("kv_len", kv_len, (b,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}")
    if cache_pos.dtype != torch.int32 \
            or tuple(cache_pos.shape) != (outer, rows) \
            or cache_pos.stride(1) != 1:
        raise ValueError(f"cache_pos must be int32 {(outer, rows)} with unit"
                         " stride along its entries")
    return s


def _launch(entry: str, q, k, v, q_pos, cache_pos, kv_len, window: int,
            k_scale, v_scale, block_table):
    q_pos_shape = ((q.shape[0],) if entry == "flash_decode"
                   else (q.shape[0], q.shape[2]))
    s = _check(q, k, v, q_pos, cache_pos, kv_len, q_pos_shape, k_scale,
               v_scale, block_table)
    b, hkv, r, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = getattr(_lib(), entry)
    int8 = k_scale is not None
    paged = block_table is not None
    p = _plan(b, hkv, r, s, q.dtype, int8, d)
    rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, q_pos.data_ptr(),
            cache_pos.data_ptr(), kv_len.data_ptr(),
            block_table.data_ptr() if paged else None, out.data_ptr(),
            b, s, hkv, r, d, block_table.shape[1] if paged else 0,
            k.shape[1] if paged else 0, k.stride(0), v.stride(0),
            k_scale.stride(0) if int8 else 0, cache_pos.stride(0),
            int(window), int(p.kernel == "mma"), p.rows, p.bk, p.stages,
            p.split, p.smem, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, cache_pos: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 block_table: Optional[torch.Tensor] = None,
                 window: int = 0) -> torch.Tensor:
    """One-token GQA decode attention on the card: one launch, each
    slot's KV sweep split over a cluster (``_plan``), on the CUDA cores
    (``simt_attn_kernel``; bf16 with more than 16 query heads a KV head
    takes ``mma_attn_kernel``).

    q: (B, Hkv, G, D) grouped queries; q_pos: (B,) int32; kv_len: (B,)
    int32 per-slot fill (the logical capacity scans everything).

    Contiguous layout (``block_table`` None): k/v (B, S, Hkv, D);
    cache_pos (B, S) int32 stored positions (−1 invalid).  Paged layout:
    k/v a pool (NB, BS, Hkv, D); cache_pos (NB, BS); ``block_table``
    (B, n) int32, slot b's logical block j in pool block
    ``block_table[b, j]``.  K/V are of q's dtype, or int8 with
    ``k_scale``/``v_scale`` f32 of K/V's shape without D.  Returns
    (B, Hkv, G, D) in q.dtype; a slot with kv_len 0 gives exact zeros.
    """
    return _launch("flash_decode", q, k, v, q_pos, cache_pos, kv_len,
                   window, k_scale, v_scale, block_table)


def flash_chunk_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, cache_pos: torch.Tensor,
                        kv_len: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        block_table: Optional[torch.Tensor] = None,
                        window: int = 0) -> torch.Tensor:
    """Chunk-prefill attention on the card: one launch, each slot's KV
    sweep split over a cluster (``_plan``); bf16 chunks of more than 16
    rows on the tensor cores (``mma_attn_kernel``), f32 and smaller ones
    on the CUDA cores (``simt_attn_kernel``).

    q: (B, Hkv, R, D) with R = C·G rows ordered (query, group); q_pos:
    (B, R) int32 per-row positions, −1 for a pad row (exact zeros); the
    cache layouts as in ``flash_decode``.  The chunk's own K/V must
    already be in the cache: in-chunk causality is ``pos <= q_pos``.
    """
    return _launch("flash_chunk_prefill", q, k, v, q_pos, cache_pos, kv_len,
                   window, k_scale, v_scale, block_table)
