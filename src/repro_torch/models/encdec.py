"""Encoder-decoder backbone (seamless-m4t-large-v2): training, one-shot
prefill, chunked prefill and decode.

The PyTorch counterpart of ``repro.models.encdec``.  The audio frontend is
a stub, as there: the encoder takes precomputed frame embeddings (B,
S_enc, d) (``api.synthetic_inputs``).  The encoder is a stack of dense
blocks with bidirectional attention, closed by ``enc_final_norm``; the
decoder's blocks add, between the causal self-attention and the SwiGLU, a
cross-attention over the encoder's output (``xattn_norm``, ``xattn``):
its keys and values are the output projected by each layer's
``xattn.wk``/``wv``, every key is visible, and its query is not roped.
Depth is a Python loop over per-layer views of the stacked weights, where
the JAX package scans; remat wraps each block in ``torch.utils.checkpoint``.

The decode cache is the dict ``{"k", "v": (L, B, S, Hkv, D), "xk", "xv":
(L, B, S_enc, Hkv, D), "full_pos": (B, S), "enc_pos": (B, S_enc)}``; the
four K/V leaves are ``Int8KV`` under native int8 and hold the
quantize-dequantize round trip under fake-quant.  The cross leaves are
fixed once the encoder has run: decode and chunk steps read all of them
and write nothing there.  Decode and chunk steps stamp ``full_pos`` once
before the decoder and write the self-attention K/V in place.  The caches
are not paged (a ``block_table`` raises), as in the reference: the serving
engines refuse enc-dec configs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import PrecisionPolicy, maybe_quant_kv
from repro_torch.kernels.ops import quant_matmul
from repro_torch.models.layers import (attention_chunk_layer,
                                       attention_decode_layer,
                                       attention_layer, rms_norm, swiglu_mlp)
from repro_torch.models.transformer import (_attn_kwargs, _layer,
                                            _maybe_remat, _write_pos,
                                            _write_pos_chunk,
                                            default_positions, dense_block,
                                            embed_tokens, lm_loss,
                                            maybe_cast_params, unembed)

Cache = Dict[str, object]
# the cache's K/V leaves: the decoder's self-attention, the cross-attention
KV_KEYS = ("k", "v", "xk", "xv")


def _cross_kwargs(cfg: ArchConfig):
    """The attention arguments of the cross-attention: no rope on the
    query (``encdec.py:72-73``, ``:244-245``)."""
    return dict(_attn_kwargs(cfg), rope_variant="none")


def _no_paging(block_table) -> None:
    if block_table is not None:
        raise NotImplementedError("enc-dec decode caches are not paged")


def encode(cfg: ArchConfig, params, enc_embeddings: torch.Tensor, *,
           remat: str = "none",
           policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (B, S_enc, d), each
    block rematerialized under ``remat``; returns (B, S_enc, d) after
    ``enc_final_norm``."""
    x = enc_embeddings.to(cfg.activation_dtype)
    b, s = x.shape[:2]
    positions = default_positions(b, s, x.device)
    block = _maybe_remat(functools.partial(dense_block, cfg, policy=policy,
                                           causal=False), remat)
    for p in params["enc_blocks"].unstack():
        x, _ = block(p, x, positions)
    return rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def cross_kv(cfg: ArchConfig, p, enc_out: torch.Tensor,
             policy: Optional[PrecisionPolicy] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K and V (B, S_enc, Hkv, D): the
    encoder's output through ``xattn.wk``/``wv``, not roped."""
    b, s = enc_out.shape[:2]
    shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (quant_matmul(enc_out, p["xattn"]["wk"], policy=policy)
            .reshape(shape),
            quant_matmul(enc_out, p["xattn"]["wv"], policy=policy)
            .reshape(shape))


def decoder_block(cfg: ArchConfig, p, x, positions, enc_out, *,
                  policy: Optional[PrecisionPolicy] = None):
    """One decoder block over a whole sequence: causal self-attention,
    cross-attention over ``enc_out`` (S queries against S_enc keys, through
    ``ops.flash_attention``), SwiGLU.  Returns (x, (k, v), (xk, xv)): the
    layer's roped self K/V and its cross K/V, for a prefill cache."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, kv = attention_layer(p["attn"], h, positions, policy=policy,
                                   **_attn_kwargs(cfg))
    x = x + attn_out
    h = rms_norm(p["xattn_norm"], x, cfg.norm_eps)
    xkv = cross_kv(cfg, p, enc_out, policy)
    x_out, _ = attention_layer(p["xattn"], h, positions, causal=False,
                               kv_override=xkv, policy=policy,
                               **_cross_kwargs(cfg))
    x = x + x_out
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy), kv, xkv


def _decoder(cfg: ArchConfig, params, tokens: torch.Tensor, enc_out, *,
             remat: str = "none", collect_cache: bool = False,
             policy: Optional[PrecisionPolicy] = None):
    """The decoder over whole token rows (B, S) against ``enc_out``, then
    the final norm.  Returns (x, positions, per-layer [(k, v, xk, xv)]
    with ``collect_cache``, else None)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = default_positions(b, s, tokens.device)
    block = _maybe_remat(functools.partial(decoder_block, cfg, policy=policy),
                         remat)
    kvs = []
    for p in params["blocks"].unstack():
        x, (k, v), (xk, xv) = block(p, x, positions, enc_out)
        if collect_cache:
            kvs.append((k, v, xk, xv))
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, positions, (kvs if collect_cache else None)


def forward_train(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor],
                  *, remat: str = "full",
                  policy: Optional[PrecisionPolicy] = None):
    """inputs: enc_embeddings (B, S_enc, d), tokens (B, S), labels (B, S)
    (−1 ignored), on the weights' device.  Returns ``lm_loss``'s (loss,
    metrics); the loss is differentiable in every weight, the encoder's
    through the cross-attention's K/V."""
    params = maybe_cast_params(params, cfg)
    enc_out = encode(cfg, params, inputs["enc_embeddings"], remat=remat,
                     policy=policy)
    x, _, _ = _decoder(cfg, params, inputs["tokens"], enc_out, remat=remat,
                       policy=policy)
    return lm_loss(unembed(params, x, cfg), inputs["labels"], cfg.vocab_size)


def _quantized(cache: Cache, policy: Optional[PrecisionPolicy]) -> Cache:
    """The cache with its K/V leaves in the policy's representation."""
    return {key: maybe_quant_kv(policy, val) if key in KV_KEYS else val
            for key, val in cache.items()}


@torch.no_grad()
def forward_prefill(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor],
                    policy: Optional[PrecisionPolicy] = None
                    ) -> Tuple[torch.Tensor, Cache]:
    """The encoder once, then the whole decoder prompt in one pass: inputs
    ``enc_embeddings`` (B, S_enc, d) and ``tokens`` (B, S).  Returns
    (last-token logits (B, V_pad), cache of exactly S decoder rows;
    ``transformer.grow_cache`` adds room to decode into).  The prompt
    attends the unquantized self and cross K/V; the cache takes the
    policy's representation afterwards, as in the reference."""
    params = maybe_cast_params(params, cfg)
    enc_out = encode(cfg, params, inputs["enc_embeddings"], policy=policy)
    x, positions, kvs = _decoder(cfg, params, inputs["tokens"], enc_out,
                                 collect_cache=True, policy=policy)
    logits = unembed(params, x[:, -1:, :], cfg)[:, 0]
    b, s_enc = enc_out.shape[:2]
    cache = {key: torch.stack(leaves) for key, leaves in
             zip(KV_KEYS, zip(*kvs))}
    cache["full_pos"] = positions.contiguous()
    cache["enc_pos"] = default_positions(b, s_enc, x.device).contiguous()
    return logits, _quantized(cache, policy)


@torch.no_grad()
def init_chunk_cache(cfg: ArchConfig, params, enc_embeddings: torch.Tensor,
                     capacity: int,
                     policy: Optional[PrecisionPolicy] = None) -> Cache:
    """An empty decoder cache of ``capacity`` rows with the cross K/V
    precomputed: the encoder runs once, each layer projects its output,
    the self-attention K/V are zeros with positions −1.  The cross K/V
    take the policy's representation here, so the chunks attend the
    quantized entries (unlike ``forward_prefill``)."""
    params = maybe_cast_params(params, cfg)
    enc_out = encode(cfg, params, enc_embeddings, policy=policy)
    b, s_enc = enc_out.shape[:2]
    xkvs = [cross_kv(cfg, p, enc_out, policy)
            for p in params["blocks"].unstack()]
    shape = (len(xkvs), b, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    dev = enc_out.device
    cache = {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
             "xk": torch.stack([xk for xk, _ in xkvs]),
             "xv": torch.stack([xv for _, xv in xkvs]),
             "full_pos": torch.full((b, capacity), -1, dtype=torch.int32,
                                    device=dev),
             "enc_pos": default_positions(b, s_enc, dev).contiguous()}
    return _quantized(cache, policy)


def forward_decode(cfg: ArchConfig, params, cache: Cache,
                   token: torch.Tensor, position: torch.Tensor,
                   write_idx: Optional[torch.Tensor] = None,
                   policy: Optional[PrecisionPolicy] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   block_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; position: (B,) int32.  ``write_idx`` and ``kv_len``
    bound and address the self-attention cache as in
    ``transformer.forward_decode`` (``kv_len == 0``: an idle row, neither
    read nor written); the cross-attention reads the whole encoder and
    writes nothing.  Returns (logits (B, V_pad), cache) with the cache
    updated in place."""
    params = maybe_cast_params(params, cfg)
    _no_paging(block_table)
    x = embed_tokens(params, token[:, None], cfg)
    widx = position if write_idx is None else write_idx
    active = None if kv_len is None else kv_len > 0
    _write_pos(cache["full_pos"], position, widx, active)
    kw = _attn_kwargs(cfg)
    for i, p in enumerate(params["blocks"].unstack()):
        h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
        x = x + attention_decode_layer(
            p["attn"], h, position, _layer(cache["k"], i),
            _layer(cache["v"], i), cache["full_pos"], widx, policy=policy,
            kv_len=kv_len, active=active, **kw)
        h = rms_norm(p["xattn_norm"], x, cfg.norm_eps)
        x = x + attention_decode_layer(
            p["xattn"], h, position, _layer(cache["xk"], i),
            _layer(cache["xv"], i), cache["enc_pos"], position,
            policy=policy, cross=True, **kw)
        h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + swiglu_mlp(p["mlp"], h, policy)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], cache


def forward_prefill_chunk(cfg: ArchConfig, params, cache: Cache,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          policy: Optional[PrecisionPolicy] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          block_table: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Cache]:
    """One decoder prefill chunk against a cache from ``init_chunk_cache``
    (the chunk contract of ``transformer.forward_prefill_chunk``): the
    self-attention writes the chunk and attends the live prefix; the
    cross-attention reads the fixed encoder K/V, its pad queries
    (position −1) attending nothing.  Returns (logits (B, C, V_pad),
    cache) with the cache updated in place."""
    params = maybe_cast_params(params, cfg)
    _no_paging(block_table)
    x = embed_tokens(params, tokens, cfg)
    write_full = positions[:, 0]
    _write_pos_chunk(cache["full_pos"], positions, write_full)
    kw, xkw = _attn_kwargs(cfg), _cross_kwargs(cfg)
    for i, p in enumerate(params["blocks"].unstack()):
        h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
        x = x + attention_chunk_layer(
            p["attn"], h, positions, _layer(cache["k"], i),
            _layer(cache["v"], i), cache["full_pos"], write_full,
            policy=policy, kv_len=kv_len, **kw)
        h = rms_norm(p["xattn_norm"], x, cfg.norm_eps)
        x = x + attention_chunk_layer(
            p["xattn"], h, positions, _layer(cache["xk"], i),
            _layer(cache["xv"], i), cache["enc_pos"], write_full,
            policy=policy, cross=True, **xkw)
        h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + swiglu_mlp(p["mlp"], h, policy)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), cache
