"""Decoder-only backbone, the serving entry points of the dense trunk.

The PyTorch counterpart of ``repro.models.transformer`` on this slice's
path: ``forward_prefill_chunk`` (one prompt chunk against a live slot
cache) and ``forward_decode`` (one token per slot).  Depth is a Python
loop over per-layer views of the stacked ``(L, ...)`` weights, where the
JAX package scans.

The cache is the dict ``{"k", "v": (L, B, S, Hkv, D), "full_pos": (B, S)
int32}`` of ``serve/kvcache.py``, or its paged form ``{"k", "v": (L, NB,
BS, Hkv, D), "pool_pos": (NB, BS)}`` addressed through a block table; K/V
leaves are float tensors or ``Int8KV`` pairs.  Both entry points update
it **in place** and return it: positions are stamped once before the
trunk (every layer attends with them), and each layer writes its K/V
rows.  ``policy`` (``core/quantize.py``) selects float, int8 or its
fake-quant simulation, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import Int8KV, PrecisionPolicy
from repro_torch.models.layers import (attention_chunk_layer,
                                       attention_decode_layer, rms_norm,
                                       swiglu_mlp, write_pages, write_rows)
from repro_torch.models.params import layer_pattern

Cache = Dict[str, object]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    return F.embedding(tokens, params["embed"]).to(cfg.activation_dtype)


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the padded vocabulary, (B, S, V_pad), in x.dtype."""
    table = params.get("unembed", params["embed"])
    return x @ table.to(x.dtype).t()


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------
def _attn_kwargs(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_variant=cfg.rope_variant,
                rope_theta=cfg.rope_theta)


def dense_block_decode(cfg: ArchConfig, p, x, position, cache_k, cache_v,
                       cache_pos, write_idx, *, policy=None, kv_len=None,
                       active=None, block_table=None):
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_decode_layer(
        p["attn"], h, position, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, active=active,
        block_table=block_table, **_attn_kwargs(cfg))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy)


def dense_block_chunk(cfg: ArchConfig, p, x, positions, cache_k, cache_v,
                      cache_pos, write_idx, *, policy=None, kv_len=None,
                      block_table=None):
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_chunk_layer(
        p["attn"], h, positions, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, block_table=block_table,
        **_attn_kwargs(cfg))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy)


def _check_uniform_dense(cfg: ArchConfig) -> None:
    kind = layer_pattern(cfg)["kind"]
    if kind != "uniform_dense":
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {kind!r} is not ported yet")


def _layer(leaf, i: int):
    """Layer ``i`` of a stacked K/V leaf (a float tensor or ``Int8KV``)."""
    if isinstance(leaf, Int8KV):
        return Int8KV(leaf.q[i], leaf.scale[i])
    return leaf[i]


def _positions(cache: Cache, block_table) -> torch.Tensor:
    """The position leaf the attention reads: the (NB, BS) pool of a
    paged cache, the (B, S) rows of a contiguous one."""
    return cache["pool_pos" if block_table is not None else "full_pos"]


def trunk_decode(cfg: ArchConfig, params, x, position, cache: Cache, *,
                 write_full, policy: Optional[PrecisionPolicy] = None,
                 kv_len: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token pass through all blocks, writing each layer's K/V row."""
    _check_uniform_dense(cfg)
    pos = _positions(cache, block_table)
    for i, p in enumerate(params["blocks"].unstack()):
        x = dense_block_decode(cfg, p, x, position, _layer(cache["k"], i),
                               _layer(cache["v"], i), pos, write_full,
                               policy=policy, kv_len=kv_len, active=active,
                               block_table=block_table)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def trunk_prefill_chunk(cfg: ArchConfig, params, x, positions,
                        cache: Cache, *, write_full,
                        policy: Optional[PrecisionPolicy] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        block_table: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """C-token pass through all blocks against the live slot cache."""
    _check_uniform_dense(cfg)
    pos = _positions(cache, block_table)
    for i, p in enumerate(params["blocks"].unstack()):
        x = dense_block_chunk(cfg, p, x, positions, _layer(cache["k"], i),
                              _layer(cache["v"], i), pos, write_full,
                              policy=policy, kv_len=kv_len,
                              block_table=block_table)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_decode(cfg: ArchConfig, params, cache: Cache,
                   token: torch.Tensor, position: torch.Tensor,
                   write_idx: Optional[torch.Tensor] = None,
                   policy: Optional[PrecisionPolicy] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   block_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; position: (B,) int32 absolute index of this token.

    ``write_idx`` (B,) is the cache row to write into; it defaults to
    ``position`` (pad-free admission keeps index == position).
    ``kv_len`` (B,) bounds each row's live region by index; ``kv_len == 0``
    marks an idle slot, which is neither read nor written.  ``None`` reads
    and writes every row.  ``block_table`` (B, n) marks ``cache`` as
    paged; ``kv_len`` is then required.  Returns (logits (B, V_pad),
    cache) with the cache updated in place.
    """
    x = embed_tokens(params, token[:, None], cfg)
    write_full = position if write_idx is None else write_idx
    active = None if kv_len is None else kv_len > 0
    if block_table is not None:
        _write_pool_pos(cache["pool_pos"], position[:, None], write_full,
                        block_table, active)
    else:
        _write_pos(cache["full_pos"], position, write_full, active)
    x = trunk_decode(cfg, params, x, position, cache, write_full=write_full,
                     policy=policy, kv_len=kv_len, active=active,
                     block_table=block_table)
    return unembed(params, x, cfg)[:, 0], cache


def _write_pos(pos_arr, position, idx, active=None) -> None:
    write_rows(pos_arr, position[:, None], idx, active)


def _write_pos_chunk(pos_arr, positions, idx) -> None:
    """Stamp a chunk's (B, C) positions at per-row offset ``idx`` (pad
    tail entries carry −1 and are written invalid)."""
    write_rows(pos_arr, positions, idx)


def _write_pool_pos(pool_pos, positions, write_idx, block_table,
                    active=None) -> None:
    """Paged sibling of ``_write_pos``/``_write_pos_chunk``: stamp (B, C)
    positions into the (NB, BS) position pool at logical rows
    ``[write_idx, write_idx + C)`` resolved through ``block_table``; rows
    with ``active == False`` are not written.  Pad entries (position −1)
    are stamped too: that keeps a recycled block free of a former
    tenant's positions inside the post-write fill."""
    bs = pool_pos.shape[1]
    c = positions.shape[1]
    tgt = (write_idx[:, None]
           + torch.arange(c, device=positions.device)[None]).long()
    blk = block_table.gather(1, tgt // bs).long()
    write_pages(pool_pos, positions, blk, tgt % bs, active)


def forward_prefill_chunk(cfg: ArchConfig, params, cache: Cache,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          policy: Optional[PrecisionPolicy] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          block_table: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Cache]:
    """One fixed-size prefill chunk against a live slot cache.

    tokens: (B, C); positions: (B, C) int32, the chunk covering
    ``[p, p + C)`` with ``p = positions[:, 0]`` and a ragged final chunk's
    pad tail at −1.  ``kv_len`` (B,) is the post-write fill ``p + C``.
    ``block_table`` (B, n) marks ``cache`` as paged.  Returns (logits
    (B, C, V_pad), cache) with the cache updated in place; the caller
    reads the next token from the last real row.
    """
    x = embed_tokens(params, tokens, cfg)
    write_full = positions[:, 0]
    if block_table is not None:
        _write_pool_pos(cache["pool_pos"], positions, write_full,
                        block_table)
    else:
        _write_pos_chunk(cache["full_pos"], positions, write_full)
    x = trunk_prefill_chunk(cfg, params, x, positions, cache,
                            write_full=write_full, policy=policy,
                            kv_len=kv_len, block_table=block_table)
    return unembed(params, x, cfg), cache
