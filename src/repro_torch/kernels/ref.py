"""Plain PyTorch versions of the attention kernels (the correctness
contracts).

Each function is the definition its CUDA kernel must reproduce: the CPU
path of ``kernels/ops.py`` runs it, and ``chip_smoke.py`` holds each
kernel against it on the card.  Semantics are those of
``repro.kernels.ref``; this slice ports the float layouts only.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_position: torch.Tensor,
                         cache_positions: torch.Tensor, *, window: int = 0,
                         kv_len: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One-token decode against a KV cache: the C == 1 case of
    ``chunk_attention_ref``.

    q: (B, 1, Hq, D); k/v: (B, S, Hkv, D); q_position: (B,);
    cache_positions: (B, S), −1 marking invalid entries; ``kv_len`` (B,)
    optionally bounds each slot's valid region by index.  A slot with no
    valid entry returns exact zeros.
    """
    return chunk_attention_ref(q, k, v, q_position[:, None], cache_positions,
                               window=window, kv_len=kv_len)


def chunk_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        cache_positions: torch.Tensor, *, window: int = 0,
                        kv_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Chunk-prefill attention: C queries per slot against the slot's cache.

    q: (B, C, Hq, D); k/v: (B, S, Hkv, D); q_positions: (B, C) absolute
    positions (−1 marks a pad query, whose row is exact zeros);
    cache_positions: (B, S) stored positions (−1 invalid); ``kv_len`` (B,)
    optionally bounds the live region by index.  An entry is valid when
    ``pos >= 0``, ``pos <= q_pos``, ``idx < kv_len`` and, with a window,
    ``pos > q_pos - window``.  Grouped-query GQA: the KV heads are never
    repeated.  Scores and softmax in float32; output in ``v.dtype``.
    """
    b, c, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = (q * d ** -0.5).reshape(b, c, hkv, g, d)
    scores = torch.einsum("bchgd,bkhd->bchgk", qg.float(), k.float())

    kp = cache_positions[:, None, :]                        # (B, 1, S)
    qp = q_positions[:, :, None]                            # (B, C, 1)
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > qp - window
    if kv_len is not None:
        idx = torch.arange(s, device=k.device, dtype=torch.int32)
        valid &= idx[None, None, :] < kv_len[:, None, None].to(torch.int32)
    vmask = valid[:, :, None, None, :]                      # (B,C,1,1,S)
    scores = torch.where(vmask, scores, NEG_INF)

    # masked softmax: a row with no valid key (a pad query, or an empty
    # slot) gives exact zeros instead of a mean over garbage
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * vmask
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bchgk,bkhd->bchgd", p.to(v.dtype), v)
    return o.reshape(b, c, hq, d)
