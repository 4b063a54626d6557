"""Serving engines: continuous, static and paged batching with chunked
pad-free prefill, on the card.

The counterparts of ``repro.serve.server``'s three engines:

* ``ContinuousBatchServer`` — a fixed set of KV-cache slots, FCFS
  admission, per-request generation budgets honored in-step, and slot
  recycling *between decode steps*.  A prompt of length S is consumed in
  ceil(S / C) fixed-size chunk steps interleaved with decode under a
  per-step token budget, each chunk written unpadded into its slot's cache
  rows ``[p, p + C)``.
* ``StaticBatchServer`` — the baseline: a batch is formed once,
  prefilled to completion through the same chunk steps, and decodes until
  its slowest member finishes.
* ``PagedBatchServer`` — continuous batching over a **paged KV pool**:
  fixed-size blocks addressed through per-slot block tables, admission by
  the free-block watermark, hash-chain prefix sharing, and
  preempt-and-recompute when the pool runs dry.

Every engine takes ``precision="float" | "int8" | "int8_fakequant"``:
int8 wraps the projection weights in ``QTensor`` once at construction,
serves through the int8 matmul kernel, and keeps the decode cache as
``Int8KV``, dequantized inside the attention kernels' tiles.  The decode
step carries each slot's exact fill as ``kv_len``, so the attention
kernels read only the live prefix of every slot.

Prompts that cannot fit a slot's capacity are rejected at ``submit``;
nothing is silently truncated.  ``use_artifact=True`` (continuous and
paged engines) serves the decode step from its deployment artifact
(paper C4, ``core/eon_compiler.compile_serve_decode``): the step is
exported once and, on the card, replayed as a CUDA graph over the
engine's own weights and cache; the chunk-prefill steps stay eager.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.core.eon_compiler import compile_serve_decode
from repro_torch.core.quantize import policy_for, quantize_model_params
from repro_torch.models.params import layer_pattern
from repro_torch.serve.kvcache import (BlockManager, PoolExhausted,
                                       alloc_decode_cache, alloc_paged_cache,
                                       decode_cache_nbytes, kv_block_size,
                                       kv_pool_block_bytes, paged_cache_keys,
                                       put_slot, release_slot)
from repro_torch.serve.scheduler import Slot, SlotScheduler
from repro_torch.serve.serve_step import (make_chunk_prefill_step,
                                          make_paged_chunk_prefill_step,
                                          make_paged_decode_step,
                                          make_slot_decode_step)

# Decode-cache capacity granularity (the JAX package's flash-decode KV
# block); capacity is rounded up to it.
KV_BLOCK = 64


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    admitted_step: Optional[int] = None   # decode-step clock at admission
    finished_step: Optional[int] = None
    preemptions: int = 0            # paged engine: times evicted/recomputed


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.is_encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: serving engine requires a token-input decoder-only"
            " architecture (enc-dec / embedding-frontend archs need a"
            " modality runner in front)")


def _chunk_rows(prompt_len: int, chunk: int) -> int:
    """Cache rows a chunked prefill touches: whole chunks, so the ragged
    final chunk's pad tail (written invalid, overwritten by decode)
    still needs rows up to the chunk boundary."""
    return -(-prompt_len // chunk) * chunk


def _summarize(served: List[Request], wall: float, *, engine: str,
               decode_steps: int, prefills: int,
               occupancy: Optional[List[int]] = None,
               n_slots: int = 0) -> Dict[str, float]:
    ttfts = np.array([r.first_token_at - r.submitted_at for r in served])
    gen = sum(len(r.tokens) for r in served)
    m: Dict[str, float] = {
        "engine": engine,
        "requests": len(served),
        "wall_s": wall,
        "ttft_mean_s": float(ttfts.mean()) if len(ttfts) else 0.0,
        "ttft_p50_s": float(np.percentile(ttfts, 50)) if len(ttfts) else 0.0,
        "ttft_p95_s": float(np.percentile(ttfts, 95)) if len(ttfts) else 0.0,
        "tokens_generated": gen,
        "tokens_per_s": gen / max(wall, 1e-9),
        "decode_steps": decode_steps,
        "prefill_chunks": prefills,
    }
    if occupancy and n_slots:
        m["mean_active_slots"] = float(np.mean(occupancy))
        m["slot_utilization"] = float(np.mean(occupancy)) / n_slots
    return m


class _ServerBase:
    def __init__(self, cfg: ArchConfig, params, precision: str = "float",
                 device: Union[str, torch.device, None] = None):
        _check_supported(cfg)
        self.device = resolve_device(device)
        weights_on = params["embed"].device
        if weights_on != self.device:
            raise ValueError(f"params are on {weights_on}, the server runs"
                             f" on {self.device}")
        self.cfg = cfg
        self.precision = precision
        self.prec = policy_for(precision)
        # int8: projection weights become QTensor leaves once, up front;
        # the serving loop never sees a float projection weight again
        self.params = quantize_model_params(params, self.prec)
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self.metrics: Dict[str, float] = {}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _slot_capacity(self) -> int:
        """Per-slot KV rows: prompt + generation budget, with headroom for
        a ragged final chunk's pad tail at max_prompt, rounded up to
        ``KV_BLOCK``; the tail is dead capacity the per-slot kv_len bound
        skips without reading."""
        need = max(self.max_prompt + self.max_new_cap,
                   _chunk_rows(self.max_prompt, self.chunk))
        return -(-need // KV_BLOCK) * KV_BLOCK

    def _init_slot_steps(self, n_slots: int) -> None:
        self._chunk_step = make_chunk_prefill_step(self.cfg, self.prec)
        self._empty_row = alloc_decode_cache(self.cfg, 1, self.capacity,
                                             self.device, self.prec)
        self.cache = alloc_decode_cache(self.cfg, n_slots, self.capacity,
                                        self.device, self.prec)
        # host mirror of the last emitted token per slot (decode feed)
        self._cur = np.zeros((n_slots,), np.int32)

    def _check_fits(self, prompt: np.ndarray, max_new: int) -> None:
        """Explicit capacity check at submit: any prompt that fits is
        served exactly; anything else errors instead of being silently
        truncated."""
        s = len(prompt)
        if s < 1:
            raise ValueError("empty prompt")
        need = max(s + max_new, _chunk_rows(s, self.chunk))
        if need > self.capacity:
            raise ValueError(
                f"prompt of {s} tokens + {max_new} new needs {need} cache"
                f" rows > slot capacity {self.capacity}; raise max_prompt/"
                f"max_new_cap (or shorten the prompt)")

    def _make_requests(self, prompts: List[np.ndarray],
                       max_new_tokens) -> List[Request]:
        if max_new_tokens is None:
            max_new_tokens = self.max_new
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        if len(max_new_tokens) != len(prompts):
            raise ValueError(f"{len(max_new_tokens)} budgets for"
                             f" {len(prompts)} prompts")
        # validate the whole batch before registering anything, so a
        # rejected prompt leaves no orphaned half-submitted requests
        checked = []
        for p, mn in zip(prompts, max_new_tokens):
            p = np.asarray(p, np.int32)
            mn = max(1, min(int(mn), self.max_new_cap))
            self._check_fits(p, mn)
            checked.append((p, mn))
        now = time.perf_counter()
        reqs = []
        for p, mn in checked:
            r = Request(rid=self._next_rid, prompt=p, max_new_tokens=mn,
                        submitted_at=now)
            self._next_rid += 1
            self.requests[r.rid] = r
            reqs.append(r)
        return reqs

    def _chunk_call(self, slot, toks, poss, kvl):
        """Run one chunk step for ``slot`` (the paged engine passes the
        slot's block-table row instead of its index)."""
        return self._chunk_step(self.params, self.cache, toks, poss,
                                slot.index, kvl)

    def _register_prefill(self, slot, prompt) -> None:
        """Hook at prefill completion (paged: publish prefix blocks)."""

    def _release_finished(self, slot) -> None:
        """Free a slot whose request finished (paged: refcount blocks)."""
        release_slot(self.cache, slot.index)
        slot.release()

    def _run_chunk(self, slot, step_clock: int) -> None:
        """One prefill chunk for ``slot``; flips it ACTIVE (and emits the
        next token) when the prompt is exhausted.  For a fresh request
        that token is its first; for a preempted request re-prefilling
        ``prompt ++ generated`` (paged engine) it is a continuation."""
        c = self.chunk
        prompt = slot.prompt
        p = slot.chunk_pos
        r = min(c, len(prompt) - p)
        toks = np.zeros((1, c), np.int32)
        poss = np.full((1, c), -1, np.int32)
        toks[0, :r] = prompt[p:p + r]
        poss[0, :r] = np.arange(p, p + r, dtype=np.int32)
        kvl = np.asarray([p + c], np.int32)
        ntok, _, self.cache = self._chunk_call(
            slot, self._tensor(toks), self._tensor(poss), self._tensor(kvl))
        slot.chunk_pos += r
        if slot.chunk_pos < len(prompt):
            return
        # final chunk: its last real row's logits are the next token
        req = self.requests[slot.rid]
        self._register_prefill(slot, prompt)
        tok0 = int(ntok[0, r - 1].item())
        req.tokens.append(tok0)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        slot.begin_decode()
        slot.generated = len(req.tokens)
        if slot.generated >= slot.max_new or tok0 == self.eos_id:
            self._finish(req, step_clock)
            self._release_finished(slot)
        else:
            self._cur[slot.index] = tok0

    def _finish(self, req: Request, step_clock: int) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        req.finished_step = step_clock
        self._served.append(req)

    def _base_metrics(self, served, wall, **kw) -> None:
        self.metrics = _summarize(served, wall, **kw)
        self.metrics["precision"] = self.precision
        self.metrics["prefill_chunk"] = self.chunk
        self.metrics["kv_cache_bytes"] = decode_cache_nbytes(self.cache)


class ContinuousBatchServer(_ServerBase):
    """Continuous batching: slot recycling between decode steps, with
    prefill chunks scheduled *inside* the decode loop.

    ``slots`` decode rows share one decode step; prompts are consumed
    ``prefill_chunk`` tokens at a time under ``prefill_token_budget``
    prefill tokens per decode step, so a long prompt cannot
    head-of-line-block the active slots' next tokens.  ``max_new_cap``
    clips every request's budget (and sizes the slots); a request stops
    early at ``eos_id``.  ``use_artifact`` serves the decode step from
    its artifact (``compile_serve_decode``); ``run()``'s metrics then
    carry ``artifact_bytes``.  ``device`` is ``cuda`` unless named;
    ``params`` must live there.
    """

    engine = "continuous"

    def __init__(self, cfg: ArchConfig, params, *,
                 slots: Optional[int] = None,
                 max_prompt: Optional[int] = None,
                 prefill_chunk: int = 8,
                 prefill_token_budget: Optional[int] = None,
                 max_new_tokens: int = 16,
                 max_new_cap: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 use_artifact: bool = False,
                 precision: str = "float",
                 device: Union[str, torch.device, None] = None):
        super().__init__(cfg, params, precision, device)
        self.use_artifact = use_artifact
        self.n_slots = int(slots or 4)
        self.max_prompt = int(max_prompt or 32)
        self.chunk = int(prefill_chunk)
        # fairness knob: prefill tokens spent per decode step once any
        # slot is actively decoding (floored at one chunk so admission
        # always progresses)
        self.prefill_budget = int(prefill_token_budget or self.chunk)
        self.max_new = int(max_new_tokens)
        self.max_new_cap = int(max_new_cap or max(self.max_new, 1))
        self.capacity = self._slot_capacity()
        self.eos_id = eos_id
        self.sched = SlotScheduler(self.n_slots)
        self._init_steps()

    def _init_steps(self) -> None:
        self._init_slot_steps(self.n_slots)
        self.decode = make_slot_decode_step(self.cfg, self.prec)
        self._deploy_decode()

    def _deploy_decode(self, **paged) -> None:
        """With ``use_artifact``, replace the decode step by its
        rehydrated artifact (``paged``: the pool's ``pool_blocks`` and
        ``block_size``) and call it once with every slot idle: kv_len 0
        everywhere, so nothing is read or written, and on the card the
        graph is captured here, over the engine's own weights and cache,
        rather than inside the first ``run()``."""
        self.artifact = None
        if not self.use_artifact:
            return
        self.artifact = compile_serve_decode(
            self.cfg, self.params, slots=self.n_slots,
            capacity=self.capacity, policy=self.prec, **paged)
        self.decode = self.artifact.rehydrate()
        idle = self._tensor(np.zeros((self.n_slots,), np.int32))
        table = (self._tensor(self.block_table),) if paged else ()
        self.decode(self.params, self.cache, idle, idle, idle, *table)

    # ------------------------------------------------------------------
    def submit(self, prompts: List[np.ndarray],
               max_new_tokens: Union[int, Sequence[int], None] = None
               ) -> List[Request]:
        reqs = self._make_requests(prompts, max_new_tokens)
        for r in reqs:
            self.sched.enqueue(r)
        return reqs

    # -- hooks the paged engine overrides -------------------------------
    def _admit(self, decode_steps: int) -> None:
        """Freed slots pick up waiting requests *now*, not at the end of a
        batch (one in-place slot-row reset each)."""
        for slot, req in self.sched.admissions():
            put_slot(self.cache, self._empty_row, slot.index)
            slot.occupy(req.rid, req.prompt, req.max_new_tokens)
            req.admitted_step = decode_steps

    def _decodable(self, active: List[Slot]) -> List[Slot]:
        return active

    def _decode_call(self, tok, pos, kvl):
        return self.decode(self.params, self.cache, tok, pos, kvl)

    def _after_decode(self) -> None:
        pass

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """Serve until queue and slots drain; returns latency metrics."""
        t0 = time.perf_counter()
        self._served: List[Request] = []
        decode_steps = 0
        prefill_chunks = 0
        occupancy: List[int] = []
        kv_raw: List[int] = []    # Σ kv_len per decode step (exact fill)

        while self.sched.busy:
            self._admit(decode_steps)

            # Budgeted chunk prefill, oldest request first: at most
            # prefill_budget prompt tokens per decode step (always at
            # least one chunk), so active slots keep emitting while long
            # prompts stream in.
            spent = 0
            for slot in sorted(self.sched.prefilling_slots(),
                               key=lambda s: s.rid):
                while slot.prefilling and spent < self.prefill_budget:
                    self._run_chunk(slot, decode_steps)
                    prefill_chunks += 1
                    spent += self.chunk
                if spent >= self.prefill_budget:
                    break

            active = self._decodable(self.sched.active_slots())
            if not active:
                continue

            pos = np.zeros((self.n_slots,), np.int32)
            # per-slot fill: pad-free, so fill == position + 1 exactly
            # (0 = idle or mid-prefill slot: skipped outright, and the
            # step suppresses its writes)
            kvl = np.zeros((self.n_slots,), np.int32)
            for s in active:
                pos[s.index] = s.position
                kvl[s.index] = s.position + 1
            ntok, _, self.cache = self._decode_call(
                self._tensor(self._cur.copy()), self._tensor(pos),
                self._tensor(kvl))
            decode_steps += 1
            occupancy.append(len(active))
            kv_raw.append(int(kvl.sum()))
            self._after_decode()
            ntok_h = ntok.cpu().numpy()

            for s in active:
                req = self.requests[s.rid]
                t = int(ntok_h[s.index])
                req.tokens.append(t)
                s.advance()
                self._cur[s.index] = t
                if s.generated >= s.max_new or t == self.eos_id:
                    self._finish(req, decode_steps)
                    self._release_finished(s)

        self._base_metrics(self._served, time.perf_counter() - t0,
                           engine=self.engine, decode_steps=decode_steps,
                           prefills=prefill_chunks, occupancy=occupancy,
                           n_slots=self.n_slots)
        if kv_raw:
            # exact live fill (entries) as a fraction of the slots x
            # capacity rectangle: the share of it the decode kernel reads
            denom = self.n_slots * self.capacity
            self.metrics["kv_fill_frac"] = float(np.mean(kv_raw) / denom)
        if self.artifact is not None:
            self.metrics["artifact_bytes"] = self.artifact.artifact_bytes
        return self.metrics


class StaticBatchServer(_ServerBase):
    """Static batching baseline: the queue is drained in fixed batches and
    every batch decodes until its *slowest* member finishes; slots are
    never recycled mid-flight.  Prefill uses the same pad-free chunk
    steps as the continuous engine (run to completion up front, no
    interleaving), so token for token the engines match; only scheduling
    differs.
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_prompt: Optional[int] = None,
                 prefill_chunk: int = 8,
                 max_new_tokens: int = 16,
                 precision: str = "float",
                 device: Union[str, torch.device, None] = None):
        super().__init__(cfg, params, precision, device)
        self.batch_size = int(batch_size)
        self.max_prompt = int(max_prompt or 32)
        self.chunk = int(prefill_chunk)
        self.max_new = int(max_new_tokens)
        self.max_new_cap = self.max_new
        self.eos_id = None
        self.capacity = self._slot_capacity()
        self.queue: List[Request] = []
        self._init_slot_steps(self.batch_size)
        self.decode = make_slot_decode_step(cfg, self.prec)

    def submit(self, prompts: List[np.ndarray],
               max_new_tokens: Union[int, Sequence[int], None] = None
               ) -> List[Request]:
        reqs = self._make_requests(prompts, max_new_tokens)
        self.queue.extend(reqs)
        return reqs

    def run(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        self._served: List[Request] = []
        decode_steps = 0
        prefill_chunks = 0
        while self.queue:
            batch = self.queue[:self.batch_size]
            self.queue = self.queue[self.batch_size:]
            slots = []
            for i, r in enumerate(batch):
                put_slot(self.cache, self._empty_row, i)
                slot = Slot(i)
                slot.occupy(r.rid, r.prompt, r.max_new_tokens)
                r.admitted_step = decode_steps
                while slot.prefilling:      # full prefill, no interleave
                    self._run_chunk(slot, decode_steps)
                    prefill_chunks += 1
                slots.append(slot)
            horizon = max(r.max_new_tokens for r in batch) - 1
            # the batch decodes as one unit until its slowest member
            # drains; finished rows keep stepping (outputs discarded)
            for _ in range(horizon):
                if not any(s.active for s in slots):
                    break
                pos = np.zeros((self.batch_size,), np.int32)
                kvl = np.zeros((self.batch_size,), np.int32)
                for s in slots:
                    if s.active:
                        pos[s.index] = s.position
                        kvl[s.index] = s.position + 1
                ntok, _, self.cache = self.decode(
                    self.params, self.cache, self._tensor(self._cur.copy()),
                    self._tensor(pos), self._tensor(kvl))
                decode_steps += 1
                ntok_h = ntok.cpu().numpy()
                for s in slots:
                    if not s.active:
                        continue
                    r = self.requests[s.rid]
                    t = int(ntok_h[s.index])
                    s.advance()
                    self._cur[s.index] = t
                    if not r.done:
                        r.tokens.append(t)
                        if len(r.tokens) >= r.max_new_tokens:
                            self._finish(r, decode_steps)

        self._base_metrics(self._served, time.perf_counter() - t0,
                           engine="static", decode_steps=decode_steps,
                           prefills=prefill_chunks)
        return self.metrics


class PagedBatchServer(ContinuousBatchServer):
    """Continuous batching over a **paged KV pool**.

    The contiguous engine holds a ``slots x capacity`` rectangle: the dead
    tail is never *read*, but it is *held* in device memory.  Here the K/V
    live in a pool of ``pool_blocks`` fixed-size blocks of ``block_size``
    entries (any divisor of the capacity >= 8; default
    ``kv_block_size(capacity)``); each slot maps its logical KV positions
    to blocks through a **block table** that the attention kernels read,
    and a host-side ``BlockManager`` owns the pool:

    * admission gates on the free-block watermark (the prompt's blocks
      must be coverable), not merely on a free slot;
    * identical prompt prefixes **share blocks** at block granularity via
      hash-chain prefix caching (``prefix_cache``; refcounted, never
      written: chunked prefill starts at the shared boundary);
    * when the pool runs dry mid-decode the youngest slot is
      **preempted**: its blocks freed, its request re-queued at the FCFS
      front and re-prefilled over ``prompt ++ generated``
      (preempt-and-recompute; greedy decoding makes it token-exact).

    Sliding-window rings and the SSM state stay slot-addressed and are
    reset at admission; only the full-attention K/V are paged.  A pure
    mamba1 trunk pages nothing, so there the engine is plain continuous
    batching with the pool bookkeeping off (no blocks, no prefix sharing,
    nothing to preempt for).  Prefix sharing needs every layer's state in
    the pool, so only the uniform dense and MoE decoders share; a ring
    trunk, or
    the hybrid trunk (its shared block's K/V paged, its SSM states not),
    pages and preempts (re-prefilling rebuilds its rings or states) but
    shares no prefix.

    The other options are those of ``ContinuousBatchServer``.
    """

    engine = "paged"

    def __init__(self, cfg: ArchConfig, params, *,
                 pool_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 prefix_cache: bool = True, **kw):
        self._pool_opts = (pool_blocks, block_size, prefix_cache)
        super().__init__(cfg, params, **kw)

    def _init_steps(self) -> None:
        pool_blocks, block_size, prefix_cache = self._pool_opts
        # raises for an unported family; () for the pure mamba1 trunk
        self.paged_keys = paged_cache_keys(self.cfg)
        self.block_size = int(block_size or kv_block_size(self.capacity))
        if self.capacity % self.block_size or self.block_size < 8:
            raise ValueError(
                f"block_size {self.block_size} must divide capacity "
                f"{self.capacity} and be >= 8")
        if self.capacity % self.chunk:
            raise ValueError(
                f"prefill_chunk {self.chunk} must divide the rounded "
                f"capacity {self.capacity} (paged blocks may not "
                f"overflow the table)")
        self.n_table = self.capacity // self.block_size
        # default pool == the contiguous rectangle's block count (no
        # preemption possible); a smaller pool trades device memory for
        # occasional preempt-and-recompute
        self.pool_blocks = int(pool_blocks or self.n_slots * self.n_table)
        if self.pool_blocks < 1:
            raise ValueError("pool_blocks must be >= 1")
        # a prefix is shared only where every layer's decode state lives
        # in the pool (the uniform dense and MoE decoders): a ring or an
        # SSM state is slot-local and must be rebuilt by an actual
        # prefill.  The MoE decoder shares as the reference does, though
        # its capacity drops couple a chunk's tokens, so a shared block's
        # K/V may differ from a recompute's
        share = prefix_cache and layer_pattern(self.cfg)["kind"] in (
            "uniform_dense", "uniform_moe")
        self.manager = BlockManager(self.pool_blocks, self.block_size,
                                    prefix_cache=share)
        self._block_bytes = kv_pool_block_bytes(
            self.cfg, self.capacity, self.prec, self.block_size)
        self._chunk_step = make_paged_chunk_prefill_step(self.cfg, self.prec)
        self.decode = make_paged_decode_step(self.cfg, self.prec)
        self.cache = alloc_paged_cache(
            self.cfg, self.n_slots, self.capacity, self.pool_blocks,
            self.device, self.prec, self.block_size)
        # pool leaves need no scrub, since a new tenant's writes precede
        # its kv_len; the slot-addressed leaves (rings, ring positions, the
        # SSM states) are reset at admission as in the contiguous engine
        pooled = set(self.paged_keys) | {"pool_pos"}
        self._empty_row = {
            k: v for k, v in alloc_paged_cache(
                self.cfg, 1, self.capacity, 1, self.device, self.prec,
                self.block_size).items() if k not in pooled}
        self._cur = np.zeros((self.n_slots,), np.int32)
        # host mirror of the block table (0 = unmapped: always a valid
        # block id; dead entries are fenced by kv_len, not by the table)
        self.block_table = np.zeros((self.n_slots, self.n_table), np.int32)
        self.preemptions = 0
        self._prompt_blocks_seen = 0
        # (rid, pool fingerprint) of the last admission that failed the
        # free-block watermark: suppresses per-step re-matching
        self._blocked_state = None
        self._live_hist: List[int] = []
        self._deploy_decode(pool_blocks=self.pool_blocks,
                            block_size=self.block_size)

    # ------------------------------------------------------------------
    def _set_table_row(self, slot) -> None:
        self.block_table[slot.index, :] = 0
        if slot.blocks:
            self.block_table[slot.index, :len(slot.blocks)] = slot.blocks

    def _free_slot(self, slot) -> None:
        """FREE path: return block references (prefix-cached blocks
        survive via the registry's own reference); no device-side scrub:
        kv_len == 0 fences the slot until re-admission."""
        self.manager.free(slot.blocks)
        slot.release()
        self._set_table_row(slot)

    def _preempt(self, slot) -> None:
        """Evict ``slot`` and re-queue its request at the FCFS front;
        re-admission re-prefills ``prompt ++ generated`` (the request keeps
        every token already emitted)."""
        req = self.requests[slot.rid]
        self._free_slot(slot)
        req.preemptions += 1
        self.preemptions += 1
        self.sched.requeue_front(req)

    def _admit(self, decode_steps: int) -> None:
        """Admission by free-block watermark, FCFS: the queue head is
        admitted when a slot is free AND the pool covers its prefill rows
        beyond any prefix-cache hit; otherwise it (and everything behind
        it) waits."""
        while self.sched.waiting:
            free = self.sched.free_slots()
            if not free:
                return
            req = self.sched.waiting[0]
            seq = (np.concatenate([req.prompt,
                                   np.asarray(req.tokens, np.int32)])
                   if req.tokens else req.prompt)
            if self.paged_keys:
                shared, need = self._match_and_reserve(req, seq)
                if need is None:
                    return
            else:
                # pure mamba1 trunk: no pooled leaves, no block accounting
                shared, need = [], 0
            self._blocked_state = None
            slot = free[0]
            self.sched.waiting.popleft()
            blocks = shared + self.manager.alloc(need)
            if self._empty_row:
                put_slot(self.cache, self._empty_row, slot.index)
            start = len(shared) * self.block_size
            slot.occupy(req.rid, seq, req.max_new_tokens)
            slot.blocks = blocks
            slot.chunk_pos = start          # prefill starts past the hit
            self._set_table_row(slot)
            if req.admitted_step is None:
                req.admitted_step = decode_steps

    def _match_and_reserve(self, req, seq):
        """The head request's prefix-cache hit and the blocks its prefill
        needs beyond it: (shared blocks, blocks to allocate), or
        (None, None) when the pool cannot cover it yet (it waits)."""
        # a blocked head request is retried every scheduler iteration:
        # skip the (hashing + LRU-touching) prefix match unless the pool
        # or registry changed since it last failed
        state = (req.rid, self.manager.free_blocks,
                 self.manager.live_blocks, self.manager.registry_size())
        if state == self._blocked_state:
            return None, None
        shared = self.manager.match_prefix(seq)
        start = len(shared) * self.block_size
        # chunk-rounded prefill rows must fit the table; drop shared
        # blocks if a misaligned chunk boundary overflows (dropped blocks
        # are not used, so not hits)
        while shared and (start + _chunk_rows(len(seq) - start, self.chunk)
                          > self.capacity):
            self.manager.unmatch(shared[-1:])
            shared = shared[:-1]
            start -= self.block_size
        rows = start + _chunk_rows(len(seq) - start, self.chunk)
        need = -(-rows // self.block_size) - len(shared)
        if not self.manager.can_alloc(need):
            # undo the match exactly (refcounts and accounting): nothing
            # was admitted, so nothing is counted
            self.manager.unmatch(shared, whole_query=True)
            if all(s.free for s in self.sched.slots):
                # nothing running could ever free blocks: this request is
                # individually unservable
                raise PoolExhausted(
                    f"request rid={req.rid} needs {need} KV blocks of"
                    f" {self.block_size} but the pool holds only"
                    f" {self.pool_blocks}")
            self._blocked_state = state
            return None, None
        self._prompt_blocks_seen += max((len(seq) - 1) // self.block_size, 0)
        return shared, need

    def _chunk_call(self, slot, toks, poss, kvl):
        row = self._tensor(self.block_table[slot.index:slot.index + 1])
        return self._chunk_step(self.params, self.cache, toks, poss, kvl,
                                row, slot.index)

    def _register_prefill(self, slot, prompt) -> None:
        """Publish the fully written prompt blocks to the prefix cache."""
        self.manager.register_prefix(prompt, slot.blocks)

    def _release_finished(self, slot) -> None:
        self._free_slot(slot)

    def _decodable(self, active: List[Slot]) -> List[Slot]:
        """Ensure every active slot owns the block this step's write lands
        in, preempting the youngest occupied slot (LIFO) whenever the pool
        runs dry.  Oldest slots grow first, so under pressure service
        order degenerates gracefully to FCFS."""
        if not self.paged_keys:
            return active                   # pure mamba1: nothing paged
        for s in sorted(active, key=lambda x: x.rid):
            while not s.free and s.position // self.block_size \
                    >= len(s.blocks):
                try:
                    s.blocks.extend(self.manager.alloc(1))
                except PoolExhausted:
                    victim = self.sched.preemption_victim()
                    self._preempt(victim)
                    if victim is s:
                        break
                    continue
                self.block_table[s.index, len(s.blocks) - 1] = s.blocks[-1]
        return [s for s in active if s.active]

    def _decode_call(self, tok, pos, kvl):
        # a fresh device copy of the host table each step; a rehydrated
        # artifact copies it into its captured buffer in stream order, so
        # no table is rewritten under a step that still reads it
        return self.decode(self.params, self.cache, tok, pos, kvl,
                           self._tensor(self.block_table))

    def _after_decode(self) -> None:
        self._live_hist.append(self.manager.live_blocks)

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """Serve until queue and slots drain; returns latency metrics plus
        pool accounting (utilization, prefix hits, preemptions)."""
        self._live_hist = []
        super().run()
        m = self.metrics
        m["kv_block_bytes"] = self._block_bytes
        m["block_size"] = self.block_size
        m["pool_blocks"] = self.pool_blocks
        m["preemptions"] = self.preemptions
        st = self.manager.stats
        m["prefix_hit_blocks"] = st["prefix_hit_blocks"]
        m["prefix_hit_rate"] = (st["prefix_hit_blocks"]
                                / self._prompt_blocks_seen
                                if self._prompt_blocks_seen else 0.0)
        live = self._live_hist
        if live:
            m["pool_live_blocks_mean"] = float(np.mean(live))
            m["pool_live_blocks_peak"] = int(np.max(live))
            m["pool_utilization"] = float(np.mean(live)) / self.pool_blocks
            m["kv_live_bytes_peak"] = int(np.max(live)) * self._block_bytes
            m["kv_live_bytes_mean"] = float(np.mean(live)) \
                * self._block_bytes
        return m


# the default engine, as the JAX package names it
BatchServer = ContinuousBatchServer
