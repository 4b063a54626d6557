"""serve_step factories: one-shot prefill, chunked prefill into one slot,
and one-token decode over every slot, on the contiguous or the paged
cache.

The counterparts of ``repro.serve.serve_step``'s prefill, contiguous
decode, slot and paged steps.
Each step closes over its ``PrecisionPolicy``, runs under
``torch.no_grad`` and updates the cache in place.  Greedy next tokens are
the argmax over the **padded** vocabulary, as in the JAX package.

With pad-free admission a cache row's index equals its entry's absolute
position, so the decode step derives its write index from ``position``
and carries only the per-slot fill ``kv_len`` (0 for an idle or
mid-prefill slot, whose row the step neither reads nor writes).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import PrecisionPolicy
from repro_torch.models.api import model_fns
from repro_torch.serve.kvcache import paged_cache_keys, take_slot


def make_prefill_step(cfg: ArchConfig,
                      policy: Optional[PrecisionPolicy] = None):
    """One-shot prefill: ``step(params, inputs) -> (next_token (B,),
    logits (B, V_pad), cache)``, the whole prompt ``inputs["tokens"]`` (B,
    S) in one pass; the cache holds exactly S rows (``transformer.
    grow_cache`` makes room to decode)."""
    fns = model_fns(cfg)

    @torch.no_grad()
    def prefill_step(params, inputs):
        logits, cache = fns.forward_prefill(cfg, params, inputs, policy)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache

    return prefill_step


def make_decode_step(cfg: ArchConfig,
                     policy: Optional[PrecisionPolicy] = None):
    """One-token decode over the contiguous cache of every row:
    ``step(params, cache, token (B,), position (B,)) -> (next_token (B,),
    logits (B, V_pad), cache)``, the cache updated in place (every row
    read and written, as the reference's ``make_decode_step``)."""
    fns = model_fns(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token, position):
        logits, cache = fns.forward_decode(cfg, params, cache, token,
                                           position, policy=policy)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache

    return decode_step


def make_chunk_prefill_step(cfg: ArchConfig,
                            policy: Optional[PrecisionPolicy] = None):
    """Chunked pad-free prefill step into one slot of the big cache:
    ``step(params, cache, tokens, positions, slot, kv_len) ->
    (next_tokens (1, C), logits, cache)``.

    tokens/positions: (1, C), the pad tail of a ragged final chunk at
    position −1; kv_len: (1,) post-write fill ``p + C``.  The chunk runs at
    batch 1 on views of the slot's row (``take_slot``), so it writes
    straight into the big cache and costs one slot's attention.
    """
    fns = model_fns(cfg)

    @torch.no_grad()
    def slot_chunk_step(params, cache, tokens, positions, slot: int, kv_len):
        logits, _ = fns.forward_prefill_chunk(
            cfg, params, take_slot(cache, slot), tokens, positions,
            policy=policy, kv_len=kv_len)
        next_tokens = logits.argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return slot_chunk_step


def make_paged_chunk_prefill_step(cfg: ArchConfig,
                                  policy: Optional[PrecisionPolicy] = None):
    """Chunk-prefill step over the paged cache: ``step(params, cache,
    tokens, positions, kv_len, block_row, slot) -> (next_tokens (1, C),
    logits, cache)``.  The pool leaves are shared by every slot, so the
    chunk addresses them through ``block_row``, the (1, n_blocks)
    block-table row of the slot being prefilled; ``kv_len`` stays the
    logical post-write fill ``p + C``.  Slot-addressed leaves (the SSM
    state) are taken as views of row ``slot``, as in the slot step."""
    fns = model_fns(cfg)
    pooled = paged_cache_keys(cfg) + ("pool_pos",)

    @torch.no_grad()
    def paged_chunk_step(params, cache, tokens, positions, kv_len,
                         block_row, slot: int):
        logits, _ = fns.forward_prefill_chunk(
            cfg, params, take_slot(cache, slot, pooled), tokens, positions,
            policy=policy, kv_len=kv_len, block_table=block_row)
        next_tokens = logits.argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return paged_chunk_step


def make_slot_decode_step(cfg: ArchConfig,
                          policy: Optional[PrecisionPolicy] = None):
    """Decode step over the slot-addressed cache (continuous batching):
    ``step(params, cache, token, position, kv_len) -> (next_token (B,),
    logits, cache)``.  ``kv_len`` (B,) is each slot's exact fill after
    this step's write (``position + 1``), 0 for an idle slot."""
    fns = model_fns(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token, position, kv_len):
        logits, cache = fns.forward_decode(cfg, params, cache, token,
                                           position, policy=policy,
                                           kv_len=kv_len)
        next_token = logits.argmax(dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


def make_paged_decode_step(cfg: ArchConfig,
                           policy: Optional[PrecisionPolicy] = None):
    """Decode step over the paged cache: ``step(params, cache, token,
    position, kv_len, block_table)``, the slot decode step's contract plus
    the (slots, n_blocks) block table that resolves each slot's logical
    KV blocks to pool blocks.  ``kv_len == 0`` still marks idle and
    mid-prefill rows: they are neither read nor written."""
    fns = model_fns(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token, position, kv_len, block_table):
        logits, cache = fns.forward_decode(cfg, params, cache, token,
                                           position, policy=policy,
                                           kv_len=kv_len,
                                           block_table=block_table)
        next_token = logits.argmax(dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step
