"""Serving engine: continuous batching with chunked pad-free prefill.

The counterpart of ``repro.serve.server.ContinuousBatchServer``, on the
card.  A fixed set of KV-cache slots, FCFS admission, per-request
generation budgets honored in-step, and slot recycling *between decode
steps*.  A prompt of length S is consumed in ceil(S / C) fixed-size chunk
steps interleaved with decode under a per-step token budget, each chunk
written unpadded into its slot's cache rows ``[p, p + C)``.  The decode
step carries each slot's exact fill as ``kv_len``, so the flash-decode
kernel reads only the live prefix of every slot.

Prompts that cannot fit a slot's capacity are rejected at ``submit``;
nothing is silently truncated.  This slice serves ``precision="float"``;
int8, the static and paged engines and the AOT artifact come later.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.serve.kvcache import (alloc_decode_cache,
                                       decode_cache_nbytes, put_slot,
                                       release_slot)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.serve_step import (make_chunk_prefill_step,
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
        if precision != "float":
            raise NotImplementedError(
                f"precision={precision!r}: int8 serving comes with port"
                " slice 2")
        self.device = resolve_device(device)
        weights_on = params["embed"].device
        if weights_on != self.device:
            raise ValueError(f"params are on {weights_on}, the server runs"
                             f" on {self.device}")
        self.cfg = cfg
        self.precision = precision
        self.params = params
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
        self._chunk_step = make_chunk_prefill_step(self.cfg)
        self._empty_row = alloc_decode_cache(self.cfg, 1, self.capacity,
                                             self.device)
        self.cache = alloc_decode_cache(self.cfg, n_slots, self.capacity,
                                        self.device)
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

    def _release_finished(self, slot) -> None:
        release_slot(self.cache, slot.index)
        slot.release()

    def _run_chunk(self, slot, step_clock: int) -> None:
        """One prefill chunk for ``slot``; flips it ACTIVE (and emits the
        first token) when the prompt is exhausted."""
        c = self.chunk
        prompt = slot.prompt
        p = slot.chunk_pos
        r = min(c, len(prompt) - p)
        toks = np.zeros((1, c), np.int32)
        poss = np.full((1, c), -1, np.int32)
        toks[0, :r] = prompt[p:p + r]
        poss[0, :r] = np.arange(p, p + r, dtype=np.int32)
        kvl = np.asarray([p + c], np.int32)
        ntok, _, self.cache = self._chunk_step(
            self.params, self.cache, self._tensor(toks), self._tensor(poss),
            slot.index, self._tensor(kvl))
        slot.chunk_pos += r
        if slot.chunk_pos < len(prompt):
            return
        # final chunk: its last real row's logits are the next token
        req = self.requests[slot.rid]
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


class ContinuousBatchServer(_ServerBase):
    """Continuous batching: slot recycling between decode steps, with
    prefill chunks scheduled *inside* the decode loop.

    ``slots`` decode rows share one decode step; prompts are consumed
    ``prefill_chunk`` tokens at a time under ``prefill_token_budget``
    prefill tokens per decode step, so a long prompt cannot
    head-of-line-block the active slots' next tokens.  ``max_new_cap``
    clips every request's budget (and sizes the slots); a request stops
    early at ``eos_id``.  ``device`` is ``cuda`` unless named; ``params``
    must live there.
    """

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
        if use_artifact:
            raise NotImplementedError(
                "use_artifact=True: the AOT decode artifact is not ported yet")
        super().__init__(cfg, params, precision, device)
        self.n_slots = int(slots or 4)
        self.max_prompt = int(max_prompt or 32)
        self.chunk = int(prefill_chunk)
        # fairness knob: prefill tokens spent per decode step once any
        # slot is actively decoding (floored at one chunk so admission
        # always progresses); see docs/scheduling.md for the trade-off.
        self.prefill_budget = int(prefill_token_budget or self.chunk)
        self.max_new = int(max_new_tokens)
        self.max_new_cap = int(max_new_cap or max(self.max_new, 1))
        self.capacity = self._slot_capacity()
        self.eos_id = eos_id
        self.sched = SlotScheduler(self.n_slots)
        self._init_slot_steps(self.n_slots)
        self.decode = make_slot_decode_step(cfg)

    # ------------------------------------------------------------------
    def submit(self, prompts: List[np.ndarray],
               max_new_tokens: Union[int, Sequence[int], None] = None
               ) -> List[Request]:
        reqs = self._make_requests(prompts, max_new_tokens)
        for r in reqs:
            self.sched.enqueue(r)
        return reqs

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
            # Admission: freed slots pick up waiting requests *now*, not
            # at the end of a batch (one in-place slot-row reset each).
            for slot, req in self.sched.admissions():
                put_slot(self.cache, self._empty_row, slot.index)
                slot.occupy(req.rid, req.prompt, req.max_new_tokens)
                req.admitted_step = decode_steps

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

            active = self.sched.active_slots()
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
            ntok, _, self.cache = self.decode(
                self.params, self.cache, self._tensor(self._cur.copy()),
                self._tensor(pos), self._tensor(kvl))
            decode_steps += 1
            occupancy.append(len(active))
            kv_raw.append(int(kvl.sum()))
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

        served = self._served
        wall = time.perf_counter() - t0
        self.metrics = _summarize(served, wall, engine="continuous",
                                  decode_steps=decode_steps,
                                  prefills=prefill_chunks,
                                  occupancy=occupancy,
                                  n_slots=self.n_slots)
        self.metrics["precision"] = self.precision
        self.metrics["prefill_chunk"] = self.chunk
        self.metrics["kv_cache_bytes"] = decode_cache_nbytes(self.cache)
        if kv_raw:
            # exact live fill (entries) as a fraction of the slots x
            # capacity rectangle: the share of it the decode kernel reads
            denom = self.n_slots * self.capacity
            self.metrics["kv_fill_frac"] = float(np.mean(kv_raw) / denom)
        return self.metrics

