"""KV-cache utilities: sizing arithmetic, the slot API the continuous and
static engines are built on, and the **paged KV pool** (block table +
``BlockManager``) the paged engine is built on.

The counterpart of ``repro.serve.kvcache`` for the uniform dense and MoE
decoders (the same K/V leaves), the local:global sliding-window trunk,
the uniform mamba1 trunk and the hybrid trunk (zamba2):

* ``kv_cache_bytes``      — footprint arithmetic.
* ``alloc_decode_cache``  — zero-filled ``slots`` x ``capacity`` decode
                            cache, positions −1 (invalid), built directly
                            from the config's shapes; with an int8 policy
                            the K/V leaves are ``Int8KV`` pairs.  The SSM
                            cache is one ``SSMState`` of (conv, h) with a
                            slot axis and no positions; the hybrid trunk's
                            sits beside its shared block's K/V.
* ``take_slot`` / ``put_slot`` / ``release_slot`` — the slot API.  Where the
  JAX package slices and splices immutable arrays, ``take_slot`` returns
  **views** of one slot's row, so a chunk step run on them writes straight
  into the big cache; ``put_slot`` copies a batch-1 cache into a row (the
  admission reset) and ``release_slot`` invalidates a row's positions, both
  in place.
* ``decode_cache_nbytes`` — device bytes of a cache.
* ``abstract_decode_cache`` / ``slot_batch_axes`` / ``paged_slot_axes`` —
  the prefill's cache on the ``meta`` device and each leaf's slot axis
  (−1: none, a pool leaf), as the reference derives them.
* ``alloc_paged_cache`` / ``abstract_paged_cache`` / ``kv_pool_block_bytes``
  — the paged layout: K/V leaves (L, NB, BS, Hkv, D) pools of fixed-size
  blocks and an (NB, BS) ``pool_pos`` position pool, addressed through a
  per-slot block table (B, capacity // BS).  The abstract cache lies on
  the ``meta`` device: shapes and dtypes, no memory.
* ``BlockManager``        — host-side pool allocator: free list, refcounts,
                            hash-chain prefix caching, LRU reclaim.

Validity is decided by stored positions (−1 = empty) plus the scheduler's
per-slot ``kv_len`` bound, so a row is recycled without touching its K/V,
and a pool block is handed to a new tenant without being scrubbed (the
new tenant's writes precede its ``kv_len``).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import Int8KV, PrecisionPolicy
from repro_torch.kernels.flash_decode import kv_block_size
from repro_torch.models.params import layer_pattern
from repro_torch.models.ssm import SSMState

Cache = Dict[str, object]

# slot (batch) axis of each leaf of a slot-addressed decode cache: the
# uniform dense decoder's, the uniform mamba1 trunk's (conv and h), the
# local:global trunk's (rings stacked (groups, ratio, B, w, ...) and
# (tail, B, w, ...), full-attention leaves (groups, B, S, ...)), and the
# hybrid trunk's shared-block K/V (groups, B, S, ...).  The SSM state's is
# the axis before its conv window's (d_conv − 1, d_inner): 1 for the
# mamba1 trunk's (L, B, ...), 2 for the hybrid's (groups, group, B, ...)
SLOT_AXES = {"k": 1, "v": 1, "full_pos": 0,
             "local_k": 2, "local_v": 2, "tail_k": 1, "tail_v": 1,
             "global_k": 1, "global_v": 1, "local_pos": 0,
             "attn_k": 1, "attn_v": 1}


def _slot_axis(key: str, leaf) -> int:
    return leaf.conv.dim() - 3 if key == "ssm" else SLOT_AXES[key]

# the leaves that live in the paged pool, by layer pattern: the
# full-attention K/V; the rings and the SSM state are slot-addressed on
# every engine (O(window) or O(state) a slot, no capacity tail to reclaim)
_PAGED_KEYS = {"uniform_dense": ("k", "v"), "uniform_moe": ("k", "v"),
               "uniform_ssm": (),
               "local_global": ("global_k", "global_v"),
               "hybrid": ("attn_k", "attn_v")}


def kv_cache_bytes(cfg: ArchConfig, batch: int, seq_len: int,
                   dtype_bytes: int = 2, *,
                   precision: str = "float") -> int:
    """Global KV/state cache footprint for one decode session.

    ``precision="int8"`` prices the Int8KV layout: 1 byte per value plus
    one f32 scale per (entry, head) vector of ``head_dim`` values —
    attention KV only; SSM recurrent state stays float either way.
    """
    hd = cfg.resolved_head_dim
    # bytes per stored attention-KV scalar; the int8 layout adds one f32
    # scale per head-vector of hd values.  SSM conv/recurrent state stays
    # float under every precision.
    kv_bytes = (hd + 4) / hd if precision == "int8" else dtype_bytes
    if cfg.family == "ssm":
        conv = batch * (cfg.d_conv - 1) * cfg.d_inner * dtype_bytes
        h = batch * cfg.d_inner * cfg.ssm_state * 4
        return int(cfg.n_layers * (conv + h))
    if cfg.family == "hybrid":
        nh = cfg.resolved_ssm_heads
        hp = cfg.d_inner // nh
        conv = batch * (cfg.d_conv - 1) * cfg.d_inner * dtype_bytes
        h = batch * nh * hp * cfg.ssm_state * 4
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        kv = n_attn * 2 * batch * seq_len * cfg.n_kv_heads * hd * kv_bytes
        return int(cfg.n_layers * (conv + h) + kv)
    per_layer_kv = 2 * batch * cfg.n_kv_heads * hd * kv_bytes
    if cfg.sliding_window and cfg.local_global_ratio:
        r = cfg.local_global_ratio
        n_global = cfg.n_layers // (r + 1)
        n_local = cfg.n_layers - n_global
        return int(n_global * per_layer_kv * seq_len
                   + n_local * per_layer_kv * min(cfg.sliding_window, seq_len))
    # Enc-dec: encoder layers hold no decode-time cache (the encoder runs
    # once; its output *is* the cross KV).  The decoder holds self-attn KV
    # over seq_len plus cross-attn KV over the subsampled encoder length.
    total = cfg.n_layers * per_layer_kv * seq_len
    if cfg.is_encdec:
        total += cfg.n_layers * per_layer_kv * (seq_len // cfg.enc_seq_divisor)
    return int(total)


# ---------------------------------------------------------------------------
# Slot-addressed decode cache (continuous and static batching)
# ---------------------------------------------------------------------------
def _pattern(cfg: ArchConfig) -> str:
    kind = layer_pattern(cfg)["kind"]
    if kind not in _PAGED_KEYS:
        raise NotImplementedError(
            f"{cfg.name}: decode cache of layer pattern {kind!r} is not"
            " ported yet")
    return kind


def _kv_leaf(shape, cfg: ArchConfig, device, policy) -> object:
    """Zero K or V leaf of ``shape`` (..., Hkv, D): the activation dtype,
    or an ``Int8KV`` pair under an int8 KV policy."""
    if policy is not None and policy.kv_cache == "int8" \
            and policy.compute == "native":
        return Int8KV(torch.zeros(shape, dtype=torch.int8, device=device),
                      torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device))
    return torch.zeros(shape, dtype=cfg.activation_dtype, device=device)


def _ring_leaves(cfg: ArchConfig, slots: int, device, policy) -> Cache:
    """The local:global trunk's empty rings: ``local_k``/``local_v``
    (groups, ratio, slots, window, Hkv, D), ``tail_k``/``tail_v`` (tail,
    slots, window, Hkv, D) where there is a tail, and ``local_pos``
    (slots, window) at −1."""
    pat = layer_pattern(cfg)
    w = cfg.sliding_window
    row = (slots, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    leaves: Cache = {}
    for key, lead in (("local", (pat["n_groups"], pat["ratio"])),
                      ("tail", (pat["tail_local"],))):
        if lead[-1]:
            for kv in "kv":
                leaves[f"{key}_{kv}"] = _kv_leaf(lead + row, cfg, device,
                                                 policy)
    leaves["local_pos"] = torch.full((slots, w), -1, dtype=torch.int32,
                                     device=device)
    return leaves


def _ssm_state(cfg: ArchConfig, lead: Tuple[int, ...], device) -> SSMState:
    """A zero SSM state of leading axes ``lead`` (layers..., slots): conv
    (d_conv − 1, d_inner) in the activation dtype; h in f32, mamba1's
    (d_inner, ssm_state), mamba2's (ssm_heads, d_inner // ssm_heads,
    ssm_state)."""
    if cfg.ssm_variant == "mamba2":
        nh = cfg.resolved_ssm_heads
        h = (nh, cfg.d_inner // nh, cfg.ssm_state)
    else:
        h = (cfg.d_inner, cfg.ssm_state)
    return SSMState(
        torch.zeros(lead + (cfg.d_conv - 1, cfg.d_inner),
                    dtype=cfg.activation_dtype, device=device),
        torch.zeros(lead + h, dtype=torch.float32, device=device))


def alloc_decode_cache(cfg: ArchConfig, slots: int, capacity: int,
                       device: Union[str, torch.device, None] = None,
                       policy: Optional[PrecisionPolicy] = None) -> Cache:
    """All-empty decode cache on ``device`` (``cuda`` unless named): K/V
    zeros (L, slots, capacity, Hkv, D) in the activation dtype (``Int8KV``
    under a native int8 KV ``policy``), positions (slots, capacity) int32
    at −1.  The local:global trunk's full-attention leaves are
    ``global_k``/``global_v`` (groups, slots, capacity, Hkv, D) beside
    ``full_pos``, and its rings those of ``_ring_leaves``, of the window's
    size whatever the capacity.  The uniform mamba1 trunk's is ``{"ssm":
    SSMState(conv (L, slots, d_conv − 1, d_inner) in the activation dtype,
    h (L, slots, d_inner, ssm_state) f32)}``, zeros under every policy,
    independent of ``capacity``.  The hybrid trunk's is the ``ssm`` state
    stacked (n_groups, group, slots, ...), mamba2's h (slots, ssm_heads,
    d_inner // ssm_heads, ssm_state), beside the shared block's
    ``attn_k``/``attn_v`` (n_groups, slots, capacity, Hkv, D) and
    ``full_pos``."""
    device = resolve_device(device)
    return {**_slot_leaves(cfg, slots, device, policy),
            **_full_leaves(cfg, slots, capacity, device, policy, "full_pos")}


def _slot_leaves(cfg: ArchConfig, slots: int, device, policy) -> Cache:
    """The leaves that are slot-addressed on every engine: the rings of
    the local:global trunk, the SSM state of the mamba1 and hybrid
    trunks."""
    kind = _pattern(cfg)
    pat = layer_pattern(cfg)
    if kind == "local_global":
        return _ring_leaves(cfg, slots, device, policy)
    if kind == "uniform_ssm":
        return {"ssm": _ssm_state(cfg, (cfg.n_layers, slots), device)}
    if kind == "hybrid":
        return {"ssm": _ssm_state(cfg, (pat["n_groups"], pat["group"], slots),
                                  device)}
    return {}


def _full_leaves(cfg: ArchConfig, outer: int, rows: int, device, policy,
                 pos_key: str) -> Cache:
    """The full-attention K/V leaves (those a paged cache pools), stacked
    over their layers, of ``outer`` slots (or pool blocks) of ``rows``
    entries, and their positions at −1 under ``pos_key``; nothing for
    the pure mamba1 trunk."""
    keys = _PAGED_KEYS[_pattern(cfg)]
    if not keys:
        return {}
    pat = layer_pattern(cfg)
    lead = (pat.get("n_layers") or pat["n_groups"],)
    shape = lead + (outer, rows, cfg.n_kv_heads, cfg.resolved_head_dim)
    leaves: Cache = {k: _kv_leaf(shape, cfg, device, policy) for k in keys}
    leaves[pos_key] = torch.full((outer, rows), -1, dtype=torch.int32,
                                 device=device)
    return leaves


def abstract_decode_cache(cfg: ArchConfig, slots: int, capacity: int,
                          policy: Optional[PrecisionPolicy] = None) -> Cache:
    """The decode cache of ``slots`` x ``capacity`` as the one-shot
    prefill builds it, on the ``meta`` device (``api.abstract_cache`` of a
    prefill cell of that batch and length), as the reference derives its
    own; with an int8 ``policy`` the K/V leaves are ``Int8KV`` pairs."""
    from repro_torch.core.arch import ShapeConfig
    from repro_torch.models.api import abstract_cache
    shape = ShapeConfig("serve_alloc", seq_len=capacity, global_batch=slots,
                        kind="prefill")
    return abstract_cache(cfg, shape, policy)


def _map_leaves(fn, tree, *rest):
    """``fn`` over the tensors of a cache tree (dicts, and the fields of
    ``Int8KV`` and ``SSMState``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(_map_leaves(fn, *xs)
                            for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def _first_diff_axis(big: torch.Tensor, small: torch.Tensor) -> int:
    """The axis where a batch-1 cache's leaf differs from the full one's
    (the batch axis: it precedes any length difference); −1 for none."""
    for i, (b, s) in enumerate(zip(big.shape, small.shape)):
        if b != s:
            return i
    return -1


def slot_batch_axes(cfg: ArchConfig, slots: int, capacity: int,
                    policy: Optional[PrecisionPolicy] = None):
    """Each leaf's batch axis in the decode cache, found by comparing the
    ``slots``-row abstract cache with its batch-1 twin (the reference's
    rule, robust to every layout); −1 marks a leaf with no batch axis
    (only where ``slots == 1``)."""
    big = abstract_decode_cache(cfg, slots, capacity, policy)
    small = abstract_decode_cache(cfg, 1, capacity, policy)
    return _map_leaves(_first_diff_axis, big, small)


def paged_slot_axes(cfg: ArchConfig, slots: int, capacity: int,
                    num_blocks: int,
                    policy: Optional[PrecisionPolicy] = None,
                    block_size: Optional[int] = None):
    """``slot_batch_axes`` of the paged cache: a slot-addressed leaf keeps
    its batch axis, a pool leaf (and ``pool_pos``) has −1, no slot axis."""
    cache = abstract_paged_cache(cfg, slots, capacity, num_blocks, policy,
                                 block_size)
    small = abstract_decode_cache(cfg, 1, capacity, policy)
    shared = set(paged_cache_keys(cfg)) | {"pool_pos"}
    return {key: (_map_leaves(lambda _: -1, leaf) if key in shared
                  else _map_leaves(_first_diff_axis, leaf, small[key]))
            for key, leaf in cache.items()}


def _tensors(leaf) -> Tuple[torch.Tensor, ...]:
    """The tensors of a leaf: itself, or the fields of an ``Int8KV`` or
    ``SSMState``."""
    return tuple(leaf) if isinstance(leaf, tuple) else (leaf,)


def decode_cache_nbytes(cache: Cache) -> int:
    """Device bytes of a decode cache: K/V values, Int8KV scales, SSM
    state and position leaves."""
    return sum(t.numel() * t.element_size() for leaf in cache.values()
               for t in _tensors(leaf))


def _row(leaf, axis: int, slot: int):
    if isinstance(leaf, tuple):
        return type(leaf)(*(t.narrow(axis, slot, 1) for t in leaf))
    return leaf.narrow(axis, slot, 1)


def take_slot(big_cache: Cache, slot: int, pooled: Sequence[str] = ()
              ) -> Cache:
    """Slot ``slot``'s row of the big cache as a batch-1 cache of **views**:
    writes to it land in the big cache.  Leaves named in ``pooled`` (a
    paged cache's pool, shared by every slot) are passed whole."""
    return {key: t if key in pooled else _row(t, _slot_axis(key, t), slot)
            for key, t in big_cache.items()}


def put_slot(big_cache: Cache, small_cache: Cache, slot: int) -> Cache:
    """Copy each leaf of a batch-1 cache into row ``slot`` of the big
    cache's leaf of that name, in place.  Putting a fresh
    ``alloc_decode_cache(cfg, 1, ...)`` resets the slot for admission
    (positions −1, SSM state zeroed)."""
    for key, leaf in small_cache.items():
        rows = _tensors(_row(big_cache[key], _slot_axis(key, leaf), slot))
        for dst, src in zip(rows, _tensors(leaf)):
            dst.copy_(src)
    return big_cache


def release_slot(big_cache: Cache, slot: int) -> Cache:
    """Invalidate a slot row in place: its positions become −1.  K/V bytes
    and SSM state stay; no position marks the K/V, so they are never
    attended, and admission resets the state.  The pool-addressed
    ``pool_pos`` is not touched: paged reuse is fenced by ``kv_len``."""
    for key, leaf in big_cache.items():
        if key.endswith("_pos") and key != "pool_pos":
            leaf[slot].fill_(-1)
    return big_cache


# ---------------------------------------------------------------------------
# Paged KV pool (block table + BlockManager)
# ---------------------------------------------------------------------------
def paged_cache_keys(cfg: ArchConfig) -> Tuple[str, ...]:
    """Cache keys that live in the paged pool: the full-attention K/V
    leaves (``k``/``v`` of the uniform dense and MoE decoders, ``global_k``/
    ``global_v`` of the local:global trunk, ``attn_k``/``attn_v`` of the
    hybrid trunk's shared block), and nothing of the pure mamba1 trunk,
    whose state is slot-addressed."""
    return _PAGED_KEYS[_pattern(cfg)]


def alloc_paged_cache(cfg: ArchConfig, slots: int, capacity: int,
                      num_blocks: int,
                      device: Union[str, torch.device, None] = None,
                      policy: Optional[PrecisionPolicy] = None,
                      block_size: Optional[int] = None) -> Cache:
    """All-empty paged decode cache: the full-attention K/V as pools (L,
    num_blocks, BS, Hkv, D) (``Int8KV`` under a native int8 KV policy) and
    a (num_blocks, BS) ``pool_pos`` pool at −1.  BS defaults to
    ``kv_block_size(capacity)`` and may be any divisor of ``capacity`` that
    is at least 8.  The uniform dense decoder has no slot-addressed leaf,
    so ``slots`` sizes nothing there; the local:global trunk keeps its
    ``slots`` rings (``_ring_leaves``) beside its pooled ``global_k``/
    ``global_v``; the hybrid trunk its ``slots``-row SSM state beside its
    pooled ``attn_k``/``attn_v``; the pure mamba1 trunk pages nothing, and
    its cache is the ``slots``-row SSM state of ``alloc_decode_cache``.
    The block table is host state of the server."""
    bs = block_size or kv_block_size(capacity)
    if capacity % bs or bs < 8:
        raise ValueError(f"block size {bs} must divide capacity {capacity}"
                         " and be >= 8")
    device = resolve_device(device)
    # a pool is a cache of num_blocks slots of BS rows
    return {**_slot_leaves(cfg, slots, device, policy),
            **_full_leaves(cfg, num_blocks, bs, device, policy, "pool_pos")}


def abstract_paged_cache(cfg: ArchConfig, slots: int, capacity: int,
                         num_blocks: int,
                         policy: Optional[PrecisionPolicy] = None,
                         block_size: Optional[int] = None) -> Cache:
    """The paged cache's shapes and dtypes, as tensors on the ``meta``
    device (no memory)."""
    return alloc_paged_cache(cfg, slots, capacity, num_blocks, "meta",
                             policy, block_size)


def kv_pool_block_bytes(cfg: ArchConfig, capacity: int,
                        policy: Optional[PrecisionPolicy] = None,
                        block_size: Optional[int] = None) -> int:
    """Device bytes one physical KV block occupies across the pool leaves
    (K/V values, Int8KV scales and its ``pool_pos`` row); 0 where nothing
    is paged."""
    keys = paged_cache_keys(cfg)
    if not keys:
        return 0
    bs = block_size or kv_block_size(capacity)
    pool = abstract_paged_cache(cfg, 1, bs, 1, policy, bs)
    return decode_cache_nbytes({k: pool[k] for k in keys + ("pool_pos",)})


class PoolExhausted(RuntimeError):
    """Raised by ``BlockManager.alloc`` when the pool cannot satisfy an
    allocation even after reclaiming cached blocks: the server's cue to
    preempt (or, at admission, to keep the request queued)."""


class BlockManager:
    """Host-side allocator for the paged KV pool.

    * **Free-list allocation** — O(1) alloc/free of fixed-size physical
      blocks; every live block has refcount ≥ 1.
    * **Prefix caching** — finished prefills register their full prompt
      blocks under a chain hash (``h_i = hash((h_{i-1}, tokens of block
      i))``); a later request whose prompt starts with the same token
      blocks shares the physical blocks (refcount++), skipping both the
      device memory and the prefill compute for the shared prefix.  The
      registry holds one reference per cached block, so cached blocks
      survive their writer's release and are reclaimed LRU only under
      pool pressure.  Shared blocks are never written: the engine starts
      chunked prefill at the shared boundary and decode writes land past
      the prompt, which is what makes block-granular sharing safe
      without copy-on-write copies (docs/paged_kv.md).
    * **Accounting** — ``live_blocks``/``free_blocks`` and hit/reclaim
      counters feed the paged server's pool metrics.

    The device never sees this object: it only materializes as the
    (slots, n_blocks) int32 block table the attention kernels read.  It
    is a copy of the JAX package's allocator (numpy and hashlib only), so
    the same calls give the same block ids, refcounts and hashes.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = prefix_cache
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self._free: deque = deque(range(self.num_blocks))
        self._cached: "OrderedDict[bytes, int]" = OrderedDict()  # digest→blk
        self._hash_of: Dict[int, bytes] = {}                     # blk→digest
        self.stats: Dict[str, int] = {
            "allocated": 0, "freed": 0, "reclaimed": 0,
            "prefix_queries": 0, "prefix_hit_blocks": 0,
        }

    # -- accounting -----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by at least one slot or the prefix cache."""
        return self.num_blocks - len(self._free)

    def _reclaimable(self) -> int:
        return sum(1 for b in self._cached.values()
                   if self.refcount[b] == 1)

    def can_alloc(self, n: int) -> bool:
        return self.free_blocks + self._reclaimable() >= n

    # -- alloc / free ---------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); reclaims LRU cached
        blocks under pressure; raises ``PoolExhausted`` if the pool
        genuinely cannot cover the request."""
        if n == 0:
            return []
        while self.free_blocks < n and self._reclaim_one():
            pass
        if self.free_blocks < n:
            raise PoolExhausted(
                f"need {n} KV blocks, {self.free_blocks} free of "
                f"{self.num_blocks} (live {self.live_blocks})")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        self.stats["allocated"] += n
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block returns to the free
        list when nothing references it (prefix-cache entries hold their
        own reference, so cached blocks survive their writer)."""
        for b in blocks:
            assert self.refcount[b] > 0, f"double free of block {b}"
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(b)
                self.stats["freed"] += 1

    def _reclaim_one(self) -> bool:
        for h, b in self._cached.items():
            if self.refcount[b] == 1:       # only the cache holds it
                del self._cached[h]
                del self._hash_of[b]
                self.refcount[b] = 0
                self._free.append(b)
                self.stats["reclaimed"] += 1
                return True
        return False

    # -- prefix caching -------------------------------------------------
    def block_hashes(self, tokens: np.ndarray) -> List[bytes]:
        """Chain digests of the token blocks fully covered by ``tokens``
        — ``h_i`` commits to the whole prefix through block ``i``, so a
        single-digest match implies the entire chain matches.  SHA-256
        over (parent digest ‖ canonical int64 token bytes): a match IS
        the content check — Python's randomized 64-bit ``hash()`` would
        make a silent cross-request KV collision merely improbable and
        unreproducible, not impossible."""
        bs = self.block_size
        h = b""
        out: List[bytes] = []
        toks = np.asarray(tokens, np.int64)
        for i in range(len(toks) // bs):
            h = hashlib.sha256(h + toks[i * bs:(i + 1) * bs].tobytes()) \
                .digest()
            out.append(h)
        return out

    def match_prefix(self, tokens: np.ndarray) -> List[int]:
        """Longest cached chain matching the prompt's leading full
        blocks, **capped at len(tokens) − 1** (the last prompt token
        must be recomputed — its logits seed generation).  Matched
        blocks come back refcounted for the caller; a caller that ends
        up not using some or all of them must hand those back through
        ``unmatch`` so references AND hit accounting stay exact."""
        self.stats["prefix_queries"] += 1
        if not self.prefix_cache:
            return []
        usable = (len(tokens) - 1) // self.block_size
        out: List[int] = []
        for h in self.block_hashes(tokens)[:usable]:
            b = self._cached.get(h)
            if b is None:
                break
            out.append(b)
            self._cached.move_to_end(h)     # LRU touch
        for b in out:
            self.refcount[b] += 1
        self.stats["prefix_hit_blocks"] += len(out)
        return out

    def unmatch(self, blocks: Sequence[int], *,
                whole_query: bool = False) -> None:
        """Exactly reverse (part of) a ``match_prefix`` the caller did
        not use: drop the references and the hit accounting, and with
        ``whole_query`` the query count too (the match never led to an
        admission).  Keeps the stat/refcount invariant inside the
        manager instead of making callers hand-reverse counters."""
        self.free(blocks)
        self.stats["prefix_hit_blocks"] -= len(blocks)
        if whole_query:
            self.stats["prefix_queries"] -= 1

    def registry_size(self) -> int:
        """Number of cached prefix blocks — with ``free_blocks``/
        ``live_blocks`` this fingerprints every state a repeated
        ``match_prefix`` could answer differently from."""
        return len(self._cached)

    def register_prefix(self, tokens: np.ndarray,
                        blocks: Sequence[int]) -> None:
        """Publish a *fully prefilled* prompt's full blocks to the
        prefix cache (one cache reference each).  Must only be called
        once the blocks' contents are final — the engine calls it when a
        prefill completes, never mid-flight, so a shared block can never
        be half-written."""
        if not self.prefix_cache:
            return
        for h, b in zip(self.block_hashes(tokens), blocks):
            if h in self._cached or b in self._hash_of:
                continue                     # first writer wins
            self._cached[h] = b
            self._hash_of[b] = h
            self.refcount[b] += 1
