"""Decoder-only backbone: the serving and training entry points of the
dense trunk, and the serving entry points of the uniform mamba1 trunk.

The PyTorch counterpart of ``repro.models.transformer`` on the port's
paths: ``forward_prefill_chunk`` (one prompt chunk against a live slot
cache), ``forward_decode`` (one token per slot) and ``forward_train``
(the whole sequence and the LM loss, differentiable; dense only).  Depth
is a Python loop over per-layer views of the stacked ``(L, ...)``
weights, where the JAX package scans; remat wraps each block in
``torch.utils.checkpoint``.

The dense cache is the dict ``{"k", "v": (L, B, S, Hkv, D), "full_pos":
(B, S) int32}`` of ``serve/kvcache.py``, or its paged form ``{"k", "v":
(L, NB, BS, Hkv, D), "pool_pos": (NB, BS)}`` addressed through a block
table; K/V leaves are float tensors or ``Int8KV`` pairs.  The SSM cache is
``{"ssm": SSMState(conv (L, B, d_conv-1, d_inner), h (L, B, d_inner,
ssm_state) f32)}``, slot-addressed on every engine.  Both entry points
update the cache **in place** and return it: positions, where the cache
has them, are stamped once before the trunk (every layer attends with
them), and each layer writes its K/V rows or its state.  ``policy``
(``core/quantize.py``) selects float, int8 or its fake-quant simulation,
as in the JAX package (the SSM family quantizes nothing).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import Int8KV, PrecisionPolicy
from repro_torch.models.layers import (attention_chunk_layer,
                                       attention_decode_layer,
                                       attention_layer, rms_norm, swiglu_mlp,
                                       write_pages, write_rows)
from repro_torch.models.params import layer_pattern
from repro_torch.models.ssm import SSMState, mamba1_decode, mamba1_layer

Cache = Dict[str, object]

# remat policies of the JAX package (``transformer.py:59``); "dots" and
# "dots_no_batch" save the matmul outputs and come with a later slice
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")


def _maybe_remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` as it is (``None``/"none"), or recomputed in the backward
    from its inputs alone ("full", the JAX package's ``nothing_saveable``):
    ``torch.utils.checkpoint`` without re-entry, so every kernel of the
    block, attention included, runs again in the backward."""
    if policy is None or policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if policy in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat policy {policy!r} (save the matmul outputs) is not ported"
            " yet; it comes with slice 10 (ROADMAP queue 1)")
    raise ValueError(f"unknown remat policy {policy!r}")


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


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy in f32 with padded-vocab masking (columns >= vocab_size
    get -1e30); labels == -1 are ignored.  Returns (loss, {"loss",
    "tokens", "ppl_log"})."""
    v_pad = logits.shape[-1]
    logits = logits.float()
    if v_pad > vocab_size:
        col = torch.arange(v_pad, device=logits.device)
        logits = logits + torch.where(col < vocab_size, 0.0, -1e30)
    valid = labels >= 0
    safe_labels = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe_labels[..., None])[..., 0]
    nll = (logz - picked) * valid
    n = valid.sum().clamp(min=1)
    loss = nll.sum() / n
    return loss, {"loss": loss, "tokens": n, "ppl_log": loss}


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------
def _attn_kwargs(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_variant=cfg.rope_variant,
                rope_theta=cfg.rope_theta)


def dense_block(cfg: ArchConfig, p, x, positions, *, policy=None):
    """One pre-norm block over a whole sequence: causal attention, then
    SwiGLU."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, _ = attention_layer(p["attn"], h, positions, policy=policy,
                                  **_attn_kwargs(cfg))
    x = x + attn_out
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy)


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


def mamba_block_chunk(cfg: ArchConfig, p, x, state, mask, fill):
    """One pre-norm mamba1 block over a chunk (or a whole prompt from
    ``state=None``); returns (x, new_state)."""
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    y, new_state = mamba1_layer(p["mamba"], h, cfg, state, mask=mask,
                                fill=fill)
    return x + y, new_state


def mamba_block_decode(cfg: ArchConfig, p, x, state, active=None):
    """One-token mamba1 block.  Rows with ``active == False`` (idle or
    mid-prefill serving slots) keep their state: the returned state equals
    ``state`` bit for bit there, so a decode step never advances the
    recurrence of a row another phase owns."""
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    y, new_state = mamba1_decode(p["mamba"], h, cfg, state)
    if active is not None:
        new_state = SSMState(*(
            torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new_state, state)))
    return x + y, new_state


def _pattern(cfg: ArchConfig) -> str:
    """The layer pattern of a served trunk: uniform dense or uniform
    mamba1."""
    kind = layer_pattern(cfg)["kind"]
    if kind not in ("uniform_dense", "uniform_ssm"):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {kind!r} is not ported yet")
    return kind


def _store_state(cache: Cache, i: int, state: SSMState) -> None:
    """Write layer ``i``'s new (conv, h) into the SSM cache in place."""
    for dst, src in zip(cache["ssm"], state):
        dst[i].copy_(src)


def _layer(leaf, i: int):
    """Layer ``i`` of a stacked K/V leaf (a float tensor or ``Int8KV``)."""
    if isinstance(leaf, Int8KV):
        return Int8KV(leaf.q[i], leaf.scale[i])
    return leaf[i]


def _positions(cache: Cache, block_table) -> torch.Tensor:
    """The position leaf the attention reads: the (NB, BS) pool of a
    paged cache, the (B, S) rows of a contiguous one."""
    return cache["pool_pos" if block_table is not None else "full_pos"]


def trunk_forward(cfg: ArchConfig, params, x, positions, *,
                  remat: str = "none",
                  policy: Optional[PrecisionPolicy] = None):
    """All blocks over a whole sequence, then the final norm; each block
    rematerialized under ``remat``.  (Collecting a prefill cache comes with
    one-shot prefill, slice 7.)"""
    if _pattern(cfg) == "uniform_ssm":
        raise NotImplementedError(
            f"{cfg.name}: training the mamba1 trunk needs the scan's"
            " gradient, which is not ported yet (ROADMAP, later work)")
    block = _maybe_remat(functools.partial(dense_block, cfg, policy=policy),
                         remat)
    for p in params["blocks"].unstack():
        x = block(p, x, positions)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def trunk_decode(cfg: ArchConfig, params, x, position, cache: Cache, *,
                 write_full, policy: Optional[PrecisionPolicy] = None,
                 kv_len: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token pass through all blocks, writing each layer's K/V row or
    (SSM) its state, the latter only on ``active`` rows."""
    if _pattern(cfg) == "uniform_ssm":
        conv, h = cache["ssm"]
        for i, p in enumerate(params["blocks"].unstack()):
            x, st = mamba_block_decode(cfg, p, x, SSMState(conv[i], h[i]),
                                       active=active)
            _store_state(cache, i, st)
        return rms_norm(params["final_norm"], x, cfg.norm_eps)
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
    """C-token pass through all blocks against the live slot cache.  An
    SSM row carries its state through the chunk: the pad tail (position
    −1) is masked out of the recurrence and the conv window."""
    if _pattern(cfg) == "uniform_ssm":
        mask = positions >= 0
        fill = mask.sum(dim=1, dtype=torch.int32)
        conv, h = cache["ssm"]
        for i, p in enumerate(params["blocks"].unstack()):
            x, st = mamba_block_chunk(cfg, p, x, SSMState(conv[i], h[i]),
                                      mask, fill)
            _store_state(cache, i, st)
        return rms_norm(params["final_norm"], x, cfg.norm_eps)
    pos = _positions(cache, block_table)
    for i, p in enumerate(params["blocks"].unstack()):
        x = dense_block_chunk(cfg, p, x, positions, _layer(cache["k"], i),
                              _layer(cache["v"], i), pos, write_full,
                              policy=policy, kv_len=kv_len,
                              block_table=block_table)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def default_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions 0..seq-1 (rope; M-RoPE comes with the
    VLM slice)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None, :].expand(batch, seq)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_train(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor],
                  *, remat: str = "full",
                  policy: Optional[PrecisionPolicy] = None):
    """inputs: tokens (B, S) int, labels (B, S) int (−1 ignored), tensors
    on the weights' device.  Returns ``lm_loss``'s (loss, metrics); the
    loss is differentiable in the weights.

    Only the default positions 0..S-1 are taken: the attention kernel masks
    by index, which equals the reference's position masks only there.
    Batches that bring ``positions`` or ``embeddings`` (packed sequences,
    the VLM frontend) raise."""
    for key in ("positions", "embeddings"):
        if key in inputs:
            raise NotImplementedError(
                f"forward_train with inputs[{key!r}] is not ported yet; it"
                " comes with slice 9 (the VLM/M-RoPE frontend)")
    tokens = inputs["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = default_positions(b, s, tokens.device)
    x = trunk_forward(cfg, params, x, positions, remat=remat, policy=policy)
    logits = unembed(params, x, cfg)
    return lm_loss(logits, inputs["labels"], cfg.vocab_size)


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
    marks an idle slot, which is neither read nor written (an SSM row
    keeps its state).  ``None`` reads and writes every row.
    ``block_table`` (B, n) marks ``cache`` as paged; ``kv_len`` is then
    required.  Returns (logits (B, V_pad), cache) with the cache updated
    in place.
    """
    x = embed_tokens(params, token[:, None], cfg)
    write_full = position if write_idx is None else write_idx
    active = None if kv_len is None else kv_len > 0
    if "pool_pos" in cache:
        _write_pool_pos(cache["pool_pos"], position[:, None], write_full,
                        block_table, active)
    elif "full_pos" in cache:
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
    if "pool_pos" in cache:
        _write_pool_pos(cache["pool_pos"], positions, write_full,
                        block_table)
    elif "full_pos" in cache:
        _write_pos_chunk(cache["full_pos"], positions, write_full)
    x = trunk_prefill_chunk(cfg, params, x, positions, cache,
                            write_full=write_full, policy=policy,
                            kv_len=kv_len, block_table=block_table)
    return unembed(params, x, cfg), cache
