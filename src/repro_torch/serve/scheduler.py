"""Slot scheduler for the continuous-batching engines (paper §4.6).

The serving analogue of the EIM process runner's queue: requests wait in
an FCFS queue; a fixed set of KV-cache *slots* is the unit of admission.
A slot's lifecycle is

    FREE ──admit──▶ PREFILLING ──last chunk──▶ ACTIVE ──finish──▶ FREE
         (reset_slot)   (chunk steps,        (decode steps)  (release_slot)
                         budgeted per            │
                         decode step)            │ pool dry (paged)
                                                 ▼
                                            PREEMPTED ──▶ back to queue
                                            (blocks freed; re-admitted
                                             FCFS-front and re-prefilled
                                             over prompt ++ generated)

Admission is cheap (host bookkeeping plus one device-side slot-row
reset — no prefill compute): the prompt is then consumed in fixed-size
chunks *interleaved with decode steps* under a per-step token budget,
each chunk written unpadded into the slot's cache rows — no pad row
ever occupies KV capacity, and a long prompt can never
head-of-line-block the active slots' next tokens.  Slots are freed
*between decode steps*, not at batch boundaries, so a short request
never waits for the longest member of its batch — that is the whole
difference between continuous and static batching.

Under the **paged** engine the admission gate is the free-block
watermark of the KV pool, not merely a free slot: a request is admitted
only when the pool covers its prompt's blocks (minus any prefix-cached
blocks it can share), and when the pool later runs dry mid-decode the
*youngest* slot is PREEMPTED — its blocks freed, its request re-queued
at the FCFS front carrying the tokens it already generated, to be
re-prefilled over ``prompt ++ generated`` (preempt-and-recompute; greedy
decoding makes the recompute token-exact).  ``Slot.blocks`` is the
host-side block-table row backing all of this (docs/paged_kv.md).

See docs/scheduling.md for the full lifecycle/budget contract.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Slot:
    """Host-side view of one decode-cache row.

    Invariants (the ``kv_len`` contract the decode kernel relies on):
    cache rows ``[0, fill)`` hold this request's live KV, rows at index
    ``>= fill`` are invalid (position −1, or garbage behind the kv_len
    bound); with pad-free admission the cache index of every entry
    equals its absolute position, so ``write_idx == position`` and the
    post-write fill is ``position + 1``.
    """
    index: int
    rid: Optional[int] = None      # request occupying the slot (None = free)
    prompt: Optional[np.ndarray] = None   # host copy while PREFILLING
    chunk_pos: int = 0             # prompt tokens already prefilled
    position: int = 0              # absolute position of the next token
    generated: int = 0             # tokens emitted for this request
    max_new: int = 0
    # paged engine only: physical KV block ids in logical order — the
    # host mirror of this slot's block-table row (prefix-shared blocks,
    # which carry extra refcounts, sit at the front; `chunk_pos` starts
    # past them).
    blocks: List[int] = dataclasses.field(default_factory=list)

    @property
    def write_idx(self) -> int:
        """Cache row of the next decode write — identically ``position``
        under pad-free admission (derived, so the two can never drift)."""
        return self.position

    @property
    def free(self) -> bool:
        return self.rid is None

    @property
    def prefilling(self) -> bool:
        return self.rid is not None and self.prompt is not None

    @property
    def active(self) -> bool:
        return self.rid is not None and self.prompt is None

    def occupy(self, rid: int, prompt: np.ndarray, max_new: int) -> None:
        """FREE → PREFILLING: park the prompt; no device work yet."""
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.chunk_pos = 0
        self.generated = 0
        self.max_new = max_new

    def begin_decode(self) -> None:
        """PREFILLING → ACTIVE: the final chunk emitted the first token
        (position ``len(prompt) − 1``), so decoding starts at
        ``position == write_idx == len(prompt)``."""
        plen = len(self.prompt)
        self.prompt = None
        self.position = plen
        self.generated = 1           # the prefill's greedy token counts

    def advance(self) -> None:
        self.position += 1
        self.generated += 1

    def release(self) -> None:
        self.rid = None
        self.prompt = None
        self.chunk_pos = 0
        self.generated = 0
        self.max_new = 0
        self.blocks = []


class SlotScheduler:
    """FCFS admission over a fixed slot set."""

    def __init__(self, n_slots: int):
        self.slots: List[Slot] = [Slot(i) for i in range(n_slots)]
        self.waiting: Deque = deque()

    def enqueue(self, req) -> None:
        self.waiting.append(req)

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.free]

    def prefilling_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.prefilling]

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.active]

    def admissions(self) -> List[Tuple[Slot, object]]:
        """Pair waiting requests with free slots (drains either side)."""
        out = []
        for slot in self.free_slots():
            if not self.waiting:
                break
            out.append((slot, self.waiting.popleft()))
        return out

    def requeue_front(self, req) -> None:
        """PREEMPTED re-entry: a preempted request outranks every
        waiting one (it has already consumed service), so it re-enters
        at the FCFS front and is re-admitted as soon as the pool covers
        its re-prefill."""
        self.waiting.appendleft(req)

    def preemption_victim(self) -> Optional[Slot]:
        """The youngest occupied slot (highest rid — least service
        received under FCFS admission).  The paged engine evicts this
        slot when the pool runs dry; the victim may be the slot whose
        growth triggered the eviction (it then skips its decode step)."""
        held = [s for s in self.slots if not s.free]
        if not held:
            return None
        return max(held, key=lambda s: s.rid)

    @property
    def busy(self) -> bool:
        return bool(self.waiting) or any(not s.free for s in self.slots)
