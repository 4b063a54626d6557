"""Decoder-only backbone: the serving, prefill and training entry points
of the uniform dense trunk, the uniform MoE trunk (each block's SwiGLU
replaced by routed experts, ``models/moe.py``) and the local:global
(sliding-window) trunk,
and the uniform mamba1 trunk and the hybrid trunk (zamba2: groups of
mamba2 blocks, each closed by one shared attention block).

The PyTorch counterpart of ``repro.models.transformer`` on the port's
paths: ``forward_prefill_chunk`` (one prompt chunk against a live slot
cache), ``forward_decode`` (one token per slot), ``forward_prefill`` (a
whole prompt in one pass, building the decode cache; ``grow_cache`` makes
room to decode into it) and ``forward_train`` (the whole sequence and the
LM loss, differentiable on every trunk).  Depth is a Python loop over
per-layer views of the stacked ``(L, ...)`` weights (the local layers'
``(groups, ratio, ...)``), where the JAX package scans; remat wraps each
block (each mamba block, and the hybrid trunk's shared block at each of
its applications) in ``torch.utils.checkpoint``.

The dense (and MoE) cache is the dict ``{"k", "v": (L, B, S, Hkv, D),
"full_pos": (B, S) int32}`` of ``serve/kvcache.py``, or its paged form
``{"k", "v": (L, NB, BS, Hkv, D), "pool_pos": (NB, BS)}`` addressed
through a block table; K/V leaves are float tensors or ``Int8KV``
pairs.  The local:global trunk's global layers keep such leaves as
``global_k``/``global_v``, its windowed layers a ring of ``window`` rows
a slot (``local_k``/``local_v``, ``tail_k``/``tail_v``, positions
``local_pos``), written at ``pos % window`` and never paged.  The SSM
cache is ``{"ssm": SSMState(conv (L, B, d_conv-1, d_inner), h (L, B,
d_inner, ssm_state) f32)}``, slot-addressed on every engine.  The hybrid
trunk's holds ``ssm`` stacked (n_groups, group, B, ...) with mamba2's h
(B, ssm_heads, head_dim, ssm_state), and beside it one K/V leaf a
shared-block application, ``attn_k``/``attn_v`` (n_groups, B, S, Hkv, D) with
``full_pos`` (paged: pools and ``pool_pos``).  The decode and chunk
entry points update the cache **in place** and return it: positions,
where the cache has them, are stamped once before the trunk (every layer
attends with them; a chunk's ring positions after it, since its ring
layers attend the ring as it was), and each layer writes its K/V rows or
its state.  ``policy``
(``core/quantize.py``) selects float, int8 or its fake-quant simulation,
as in the JAX package (the SSM family quantizes nothing).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import flags
from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import (Int8KV, PrecisionPolicy, QTensor,
                                       maybe_quant_kv)
from repro_torch.core.tree import as_tree
from repro_torch.models.layers import (attention_chunk_layer,
                                       attention_decode_layer,
                                       attention_layer, ring_scatter,
                                       ring_scatter_idx, rms_norm,
                                       swiglu_mlp, write_pages, write_rows)
from repro_torch.models.moe import moe_layer
from repro_torch.models.params import TreeView, layer_pattern
from repro_torch.models.ssm import (SSMState, mamba1_decode, mamba1_layer,
                                    mamba2_decode, mamba2_layer)

Cache = Dict[str, object]

# remat policies of the JAX package (``transformer.py:59``)
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")
_aten = torch.ops.aten
# the products whose outputs "dots_no_batch" (the JAX package's
# ``checkpoint_dots_with_no_batch_dims``) keeps: the 2-D ones, every
# projection; "dots" (``checkpoint_dots``) keeps the batched ones too (the
# MoE expert banks, the SSD einsums)
_SAVED_PRODUCTS = {
    "dots_no_batch": frozenset((_aten.mm.default, _aten.addmm.default)),
    "dots": frozenset((_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default))}


def _saving(products: frozenset) -> Callable:
    """A selective-checkpoint context that keeps the outputs of
    ``products`` and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in products
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _maybe_remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` as it is (``None``/"none"), or under ``torch.utils.checkpoint``
    without re-entry: "full" (the JAX package's ``nothing_saveable``)
    recomputes the whole block in the backward from its inputs; "dots" and
    "dots_no_batch" keep the outputs of ``_SAVED_PRODUCTS`` and recompute
    the rest.  The attention (the operator ``repro_torch::flash_attention``
    on either device) is no product and holds no score matrix to keep, so
    it runs again under every policy, as under "full"."""
    if policy is None or policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if policy in _SAVED_PRODUCTS:
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=_saving(_SAVED_PRODUCTS[policy]))
    raise ValueError(f"unknown remat policy {policy!r}")


def maybe_cast_params(params, cfg: ArchConfig):
    """Under the ``bf16_params`` flag (``flags.py``), the weights with the
    float32 masters of two or more dimensions cast to the activation dtype
    once at the entry point (a ``TreeView``; the casts are differentiable,
    so gradients still reach the masters); 1-D scales, the SSM dynamics
    that are 1-D and ``QTensor`` leaves stay as they are.  Without the flag,
    ``params`` itself.  The reference's barrier (``transformer.py:52-57``)
    keeps XLA from sinking the cast into its layer scan; eager PyTorch
    casts where it is asked to and needs none."""
    if not flags.get("bf16_params"):
        return params
    dt = cfg.activation_dtype

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v if isinstance(v, QTensor)
                    else v.to(dt) if v.dim() >= 2 and v.dtype == torch.float32
                    else v)
                for k, v in tree.items()}
    return TreeView(cast(as_tree(params)))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    """The token embeddings in the activation dtype; gemma scales them by
    sqrt(d_model), rounded once to that dtype, as the JAX package does."""
    x = F.embedding(tokens, params["embed"]).to(cfg.activation_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


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
def _attn_kwargs(cfg: ArchConfig, window: int = 0):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_variant=cfg.rope_variant,
                rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
                window=window)


def dense_block(cfg: ArchConfig, p, x, positions, *, window: int = 0,
                policy=None, causal: bool = True, mask_pos=None):
    """One pre-norm block over a whole sequence: causal (``window``:
    sliding-window; ``causal=False``: bidirectional, the enc-dec encoder's)
    attention, masked by ``mask_pos`` (B, S), the positions' temporal
    stream, where given (else by index), then SwiGLU.  Returns (x, (k,
    v)), the layer's roped K and V for a prefill cache."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, kv = attention_layer(p["attn"], h, positions, policy=policy,
                                   causal=causal, mask_pos=mask_pos,
                                   **_attn_kwargs(cfg, window))
    x = x + attn_out
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy), kv


def dense_block_decode(cfg: ArchConfig, p, x, position, cache_k, cache_v,
                       cache_pos, write_idx, *, window: int = 0, policy=None,
                       kv_len=None, active=None, block_table=None):
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_decode_layer(
        p["attn"], h, position, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, active=active,
        block_table=block_table, **_attn_kwargs(cfg, window))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy)


def dense_block_chunk(cfg: ArchConfig, p, x, positions, cache_k, cache_v,
                      cache_pos, write_idx, *, window: int = 0, policy=None,
                      kv_len=None, block_table=None):
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_chunk_layer(
        p["attn"], h, positions, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, block_table=block_table,
        **_attn_kwargs(cfg, window))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + swiglu_mlp(p["mlp"], h, policy)


def moe_block(cfg: ArchConfig, p, x, positions, *, window: int = 0,
              policy=None, mask_pos=None):
    """``dense_block`` with the experts (``moe_layer``) in place of the
    SwiGLU: the router and the banks stay float under every policy."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    attn_out, kv = attention_layer(p["attn"], h, positions, policy=policy,
                                   mask_pos=mask_pos,
                                   **_attn_kwargs(cfg, window))
    x = x + attn_out
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + moe_layer(p["moe"], h, cfg), kv


def moe_block_decode(cfg: ArchConfig, p, x, position, cache_k, cache_v,
                     cache_pos, write_idx, *, window: int = 0, policy=None,
                     kv_len=None, active=None, block_table=None):
    """One token a slot; every slot is routed, the idle ones too (they
    take capacity, as in the reference's step)."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_decode_layer(
        p["attn"], h, position, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, active=active,
        block_table=block_table, **_attn_kwargs(cfg, window))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + moe_layer(p["moe"], h, cfg)


def moe_block_chunk(cfg: ArchConfig, p, x, positions, cache_k, cache_v,
                    cache_pos, write_idx, *, window: int = 0, policy=None,
                    kv_len=None, block_table=None):
    """A chunk against the cache; its pad rows are routed and take
    capacity, as in the reference's step."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attention_chunk_layer(
        p["attn"], h, positions, cache_k, cache_v, cache_pos, write_idx,
        policy=policy, kv_len=kv_len, block_table=block_table,
        **_attn_kwargs(cfg, window))
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + moe_layer(p["moe"], h, cfg)


# the attention trunks' block bodies (whole sequence, decode, chunk), by
# layer pattern: the MoE decoder's, every other attention trunk's
_BODIES = {"uniform_moe": (moe_block, moe_block_decode, moe_block_chunk)}
_DENSE_BODIES = (dense_block, dense_block_decode, dense_block_chunk)


def _bodies(cfg: ArchConfig):
    return _BODIES.get(_pattern(cfg), _DENSE_BODIES)


# the layer and the one-token step of each SSM variant
_MAMBA = {"mamba1": (mamba1_layer, mamba1_decode),
          "mamba2": (mamba2_layer, mamba2_decode)}


def mamba_block(cfg: ArchConfig, p, x):
    """One pre-norm mamba block over a whole sequence from a zero state;
    returns (x, final_state)."""
    return mamba_block_chunk(cfg, p, x, None, None, None)


def mamba_block_chunk(cfg: ArchConfig, p, x, state, mask, fill):
    """One pre-norm mamba block (the config's ``ssm_variant``) over a
    chunk (or a whole prompt from ``state=None``); returns (x,
    new_state)."""
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    y, new_state = _MAMBA[cfg.ssm_variant][0](p["mamba"], h, cfg, state,
                                              mask=mask, fill=fill)
    return x + y, new_state


def mamba_block_decode(cfg: ArchConfig, p, x, state, active=None):
    """One-token mamba block.  Rows with ``active == False`` (idle or
    mid-prefill serving slots) keep their state: the returned state equals
    ``state`` bit for bit there, so a decode step never advances the
    recurrence of a row another phase owns."""
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    y, new_state = _MAMBA[cfg.ssm_variant][1](p["mamba"], h, cfg, state)
    if active is not None:
        new_state = SSMState(*(
            torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new_state, state)))
    return x + y, new_state


def _pattern(cfg: ArchConfig) -> str:
    """The layer pattern of a served trunk: uniform dense, uniform MoE,
    uniform mamba1, local:global (sliding-window ring) or hybrid (mamba2
    groups and a shared attention block)."""
    kind = layer_pattern(cfg)["kind"]
    if kind not in ("uniform_dense", "uniform_moe", "uniform_ssm",
                    "local_global", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {kind!r} is not ported yet")
    return kind


def _store_state(cache: Cache, i, state: SSMState) -> None:
    """Write layer ``i``'s (an index, or (group, layer) of the hybrid
    trunk) new (conv, h) into the SSM cache in place."""
    for dst, src in zip(cache["ssm"], state):
        dst[i].copy_(src)


def _layer(leaf, i):
    """Layer ``i`` (an index or a tuple of them) of a stacked K/V leaf (a
    float tensor or ``Int8KV``)."""
    if isinstance(leaf, Int8KV):
        return Int8KV(leaf.q[i], leaf.scale[i])
    return leaf[i]


def _positions(cache: Cache, block_table) -> torch.Tensor:
    """The position leaf the full-attention layers read: the (NB, BS)
    pool of a paged cache, the (B, S) rows of a contiguous one."""
    return cache["pool_pos" if block_table is not None else "full_pos"]


def _trunk_layers(cfg: ArchConfig, params):
    """Every attention layer of an attention trunk in order, as (block
    weights, window, cache prefix, index into the stacked cache leaves):
    the uniform dense and MoE decoders' ``k``/``v`` by layer; the local:global
    trunk's groups of ``ratio`` windowed layers (``local_k``/``local_v``
    at (group, i)) each closed by a full-attention layer (``global_k``/
    ``global_v`` at group), then the windowed tail (``tail_k``/``tail_v``)."""
    if _pattern(cfg) in ("uniform_dense", "uniform_moe"):
        for i, p in enumerate(params["blocks"].unstack()):
            yield p, 0, "", i
        return
    w = cfg.sliding_window
    groups = params["groups"]
    for g, (local, glob) in enumerate(zip(groups["local"].unstack(2),
                                          groups["global"].unstack())):
        for r, p in enumerate(local):
            yield p, w, "local_", (g, r)
        yield glob, 0, "global_", g
    if "tail_local" in params:
        for t, p in enumerate(params["tail_local"].unstack()):
            yield p, w, "tail_", t


def _stacked(kvs, shape):
    """Stack per-layer (B, S, Hkv, D) tensors into a leaf of leading
    ``shape``."""
    return torch.stack(kvs).reshape(tuple(shape) + kvs[0].shape)


def trunk_forward(cfg: ArchConfig, params, x, positions, *,
                  remat: str = "none", collect_cache: bool = False,
                  policy: Optional[PrecisionPolicy] = None,
                  mask_pos: Optional[torch.Tensor] = None):
    """All blocks over a whole sequence, then the final norm; each block
    rematerialized under ``remat``.  positions: (B, S), or (B, S, 3) under
    M-RoPE; every attention layer masks by ``mask_pos`` (B, S) int32,
    their temporal stream, where given, else by index.  Returns (x, caches): with
    ``collect_cache``, each layer's roped K/V (stacked as the decode
    cache's leaves) or, for the mamba1 trunk, its final ``SSMState``;
    else None."""
    kind = _pattern(cfg)
    if kind == "hybrid":
        return _hybrid_forward(cfg, params, x, positions, collect_cache,
                               policy, mask_pos, remat)
    if kind == "uniform_ssm":
        body = _maybe_remat(functools.partial(mamba_block, cfg), remat)
        states = []
        for p in params["blocks"].unstack():
            x, st = body(p, x)
            states.append(st)
        caches = {"ssm": _stack_states(states, (len(states),))}
        return rms_norm(params["final_norm"], x, cfg.norm_eps), \
            (caches if collect_cache else None)
    blocks = {}
    kvs: Dict[str, list] = {}
    body = _bodies(cfg)[0]
    for p, window, prefix, _ in _trunk_layers(cfg, params):
        if window not in blocks:
            blocks[window] = _maybe_remat(functools.partial(
                body, cfg, window=window, policy=policy,
                mask_pos=mask_pos), remat)
        x, (k, v) = blocks[window](p, x, positions)
        if collect_cache:
            kvs.setdefault(prefix + "k", []).append(k)
            kvs.setdefault(prefix + "v", []).append(v)
    caches = None
    if collect_cache:
        pat = layer_pattern(cfg)
        shapes = {"k": (pat.get("n_layers"),),
                  "local_k": (pat.get("n_groups"), pat.get("ratio")),
                  "global_k": (pat.get("n_groups"),),
                  "tail_k": (pat.get("tail_local"),)}
        caches = {key: _stacked(val, shapes[key[:-1] + "k"])
                  for key, val in kvs.items()}
    return rms_norm(params["final_norm"], x, cfg.norm_eps), caches


def _stack_states(states, lead) -> SSMState:
    """Stack per-layer ``SSMState``s into one of leading ``lead``."""
    return SSMState(*(torch.stack(t).reshape(tuple(lead) + t[0].shape)
                      for t in zip(*states)))


def _hybrid_forward(cfg: ArchConfig, params, x, positions, collect_cache,
                    policy, mask_pos=None, remat: str = "none"):
    """The hybrid trunk over a whole sequence: each group's mamba2 blocks,
    then the shared attention block, each block (the shared one at each of
    its applications) rematerialized under ``remat``, as the reference's.
    The caches, with ``collect_cache``: the final states stacked
    (n_groups, group, ...) and each application's roped K/V as
    ``attn_k``/``attn_v``."""
    shared = params["shared_attn"]
    mamba = _maybe_remat(functools.partial(mamba_block, cfg), remat)
    attend = _maybe_remat(functools.partial(
        dense_block, cfg, policy=policy, mask_pos=mask_pos), remat)
    states, ks, vs = [], [], []
    groups = params["groups"].unstack(2)
    for group in groups:
        for p in group:
            x, st = mamba(p, x)
            states.append(st)
        x, (k, v) = attend(shared, x, positions)
        ks.append(k)
        vs.append(v)
    caches = None
    if collect_cache:
        n_groups = len(groups)
        caches = {"ssm": _stack_states(states, (n_groups, len(groups[0]))),
                  "attn_k": _stacked(ks, (n_groups,)),
                  "attn_v": _stacked(vs, (n_groups,))}
    return rms_norm(params["final_norm"], x, cfg.norm_eps), caches


def _hybrid_trunk(cfg: ArchConfig, params, x, cache: Cache, mamba,
                  attend) -> torch.Tensor:
    """The hybrid trunk against the serving cache: group g's mamba2 blocks
    each run ``mamba(p, x, state)`` on their state at (g, j) and write it
    back; then the shared block ``attend(x, cache_k, cache_v)`` on the
    group's own K/V, ``attn_k[g]``/``attn_v[g]``."""
    conv, h = cache["ssm"]
    for g, group in enumerate(params["groups"].unstack(2)):
        for j, p in enumerate(group):
            x, st = mamba(p, x, SSMState(conv[g, j], h[g, j]))
            _store_state(cache, (g, j), st)
        x = attend(x, _layer(cache["attn_k"], g), _layer(cache["attn_v"], g))
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def _attention_trunk(cfg: ArchConfig, params, x, cache: Cache, block,
                     full_pos) -> torch.Tensor:
    """Run ``block(p, x, cache_k, cache_v, cache_pos, window)`` over every
    attention layer, each on its own layer of the cache; full-attention
    layers read ``full_pos``, windowed ones the ring's ``local_pos``."""
    for p, window, prefix, i in _trunk_layers(cfg, params):
        pos = cache["local_pos"] if window else full_pos
        x = block(p, x, _layer(cache[prefix + "k"], i),
                  _layer(cache[prefix + "v"], i), pos, window)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def trunk_decode(cfg: ArchConfig, params, x, position, cache: Cache, *,
                 write_full, write_local=None,
                 policy: Optional[PrecisionPolicy] = None,
                 kv_len: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token pass through all blocks, writing each layer's K/V row
    (ring layers at ``write_local``, slot-addressed on every engine) or
    (SSM) its state, the latter only on ``active`` rows."""
    if _pattern(cfg) == "hybrid":
        shared, pos = params["shared_attn"], _positions(cache, block_table)
        return _hybrid_trunk(
            cfg, params, x, cache,
            lambda p, x, st: mamba_block_decode(cfg, p, x, st, active),
            lambda x, ck, cv: dense_block_decode(
                cfg, shared, x, position, ck, cv, pos, write_full,
                policy=policy, kv_len=kv_len, active=active,
                block_table=block_table))
    if _pattern(cfg) == "uniform_ssm":
        conv, h = cache["ssm"]
        for i, p in enumerate(params["blocks"].unstack()):
            x, st = mamba_block_decode(cfg, p, x, SSMState(conv[i], h[i]),
                                       active=active)
            _store_state(cache, i, st)
        return rms_norm(params["final_norm"], x, cfg.norm_eps)

    body = _bodies(cfg)[1]

    def block(p, x, ck, cv, pos, window):
        return body(
            cfg, p, x, position, ck, cv, pos,
            write_local if window else write_full, window=window,
            policy=policy, kv_len=kv_len, active=active,
            block_table=None if window else block_table)
    return _attention_trunk(cfg, params, x, cache, block,
                            _positions(cache, block_table))


def trunk_prefill_chunk(cfg: ArchConfig, params, x, positions,
                        cache: Cache, *, write_full,
                        policy: Optional[PrecisionPolicy] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        block_table: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """C-token pass through all blocks against the live slot cache.  An
    SSM row carries its state through the chunk: the pad tail (position
    −1) is masked out of the recurrence and the conv window.  Ring layers
    attend ``[ring ∥ chunk]`` and then scatter the chunk's winners in."""
    mask = positions >= 0
    fill = mask.sum(dim=1, dtype=torch.int32)
    if _pattern(cfg) == "hybrid":
        shared, pos = params["shared_attn"], _positions(cache, block_table)
        return _hybrid_trunk(
            cfg, params, x, cache,
            lambda p, x, st: mamba_block_chunk(cfg, p, x, st, mask, fill),
            lambda x, ck, cv: dense_block_chunk(
                cfg, shared, x, positions, ck, cv, pos, write_full,
                policy=policy, kv_len=kv_len, block_table=block_table))
    if _pattern(cfg) == "uniform_ssm":
        conv, h = cache["ssm"]
        for i, p in enumerate(params["blocks"].unstack()):
            x, st = mamba_block_chunk(cfg, p, x, SSMState(conv[i], h[i]),
                                      mask, fill)
            _store_state(cache, i, st)
        return rms_norm(params["final_norm"], x, cfg.norm_eps)

    body = _bodies(cfg)[2]

    def block(p, x, ck, cv, pos, window):
        return body(
            cfg, p, x, positions, ck, cv, pos, write_full, window=window,
            policy=policy, kv_len=kv_len,
            block_table=None if window else block_table)
    return _attention_trunk(cfg, params, x, cache, block,
                            _positions(cache, block_table))


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def default_positions(batch: int, seq: int, device=None,
                      cfg: Optional[ArchConfig] = None) -> torch.Tensor:
    """(batch, seq) int32 positions 0..seq-1; under ``cfg``'s M-RoPE
    (batch, seq, 3), three equal streams (``transformer.py:451-455``)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    pos = pos[None, :].expand(batch, seq)
    if cfg is not None and cfg.rope_variant == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos


def _trunk_inputs(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor]):
    """The first hidden state and the positions of a whole-sequence batch
    (``transformer.py:463-503``): ``embeddings`` (B, S, d), the stub
    frontend's, cast to the activation dtype, or ``tokens`` (B, S)
    embedded; ``positions`` as brought ((B, S), or (B, S, 3) under
    M-RoPE), else ``default_positions``.  Returns (x, positions,
    mask_pos): the attention masks by ``mask_pos``, the positions'
    temporal stream (B, S) as contiguous int32, only where the caller
    brought them; for the default ones it is None, the index masks (the
    same masks, the kernels' index launch)."""
    if "embeddings" in inputs:
        x = inputs["embeddings"].to(cfg.activation_dtype)
    else:
        x = embed_tokens(params, inputs["tokens"], cfg)
    b, s = x.shape[:2]
    positions = inputs.get("positions")
    if positions is None:
        return x, default_positions(b, s, x.device, cfg), None
    mask_pos = positions if positions.dim() == 2 else positions[..., 0]
    return x, positions, mask_pos.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_train(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor],
                  *, remat: str = "full",
                  policy: Optional[PrecisionPolicy] = None):
    """inputs: tokens (B, S) int or embeddings (B, S, d); labels (B, S) int
    (−1 ignored); optionally positions (B, S), or (B, S, 3) under M-RoPE
    (packed rows, an image's patches); tensors on the weights' device.
    Returns ``lm_loss``'s (loss, metrics); the loss is differentiable in
    the weights (and in the embeddings where they require it)."""
    params = maybe_cast_params(params, cfg)
    x, positions, mask_pos = _trunk_inputs(cfg, params, inputs)
    x, _ = trunk_forward(cfg, params, x, positions, remat=remat,
                         policy=policy, mask_pos=mask_pos)
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
    params = maybe_cast_params(params, cfg)
    x = embed_tokens(params, token[:, None], cfg)
    w = cfg.sliding_window
    write_full = position if write_idx is None else write_idx
    write_local = position % w if w else write_full
    active = None if kv_len is None else kv_len > 0
    if "pool_pos" in cache:
        _write_pool_pos(cache["pool_pos"], position[:, None], write_full,
                        block_table, active)
    elif "full_pos" in cache:
        _write_pos(cache["full_pos"], position, write_full, active)
    if "local_pos" in cache:
        _write_pos(cache["local_pos"], position, write_local, active)
    x = trunk_decode(cfg, params, x, position, cache, write_full=write_full,
                     write_local=write_local, policy=policy, kv_len=kv_len,
                     active=active, block_table=block_table)
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
    params = maybe_cast_params(params, cfg)
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
    if "local_pos" in cache:
        # after the trunk: every ring layer attended the ring's old stamp
        ring_scatter(cache["local_pos"], positions,
                     ring_scatter_idx(positions, cfg.sliding_window))
    return unembed(params, x, cfg), cache


# ---------------------------------------------------------------------------
# One-shot prefill and its cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward_prefill(cfg: ArchConfig, params, inputs: Dict[str, torch.Tensor],
                    policy: Optional[PrecisionPolicy] = None
                    ) -> Tuple[torch.Tensor, Cache]:
    """The whole prompt in one pass: inputs["tokens"] (B, S) or
    inputs["embeddings"] (B, S, d), and optionally inputs["positions"]
    ((B, S), or (B, S, 3) under M-RoPE), as in ``forward_train``.  Returns
    (last-token logits (B, V_pad), cache): the decode cache of exactly S
    rows (``grow_cache`` adds room to decode into), its positions the
    temporal stream, its K/V in the ``policy``'s representation
    (``Int8KV`` under native int8, their quantize-dequantize round trip
    under fake-quant), quantized after the cache is built."""
    params = maybe_cast_params(params, cfg)
    x, positions, mask_pos = _trunk_inputs(cfg, params, inputs)
    x, caches = trunk_forward(cfg, params, x, positions, collect_cache=True,
                              policy=policy, mask_pos=mask_pos)
    logits = unembed(params, x[:, -1:, :], cfg)[:, 0]
    return logits, _cache_from_prefill(cfg, caches, positions, policy)


def _ring_select(pos1d: torch.Tensor, w: int):
    """Per-row ring placement of a prefill: pos1d (B, S) absolute
    positions, −1 marking pad entries.  The ring keeps each row's w most
    recent real entries at row ``pos % w``.  Returns (src (B, w), the
    source index into S of each ring row; has (B, w), whether the row is
    filled; local_pos (B, w) int32, its position or −1)."""
    max_pos = pos1d.max(dim=1, keepdim=True).values
    keep = (pos1d >= 0) & (pos1d > max_pos - w)
    slot_of = torch.where(keep, pos1d % w, w)
    slot_ids = torch.arange(w, dtype=pos1d.dtype,
                            device=pos1d.device)[None, :, None]
    match = slot_of[:, None, :] == slot_ids                    # (B, w, S)
    src = torch.argmax(match.to(torch.int32), dim=-1)          # first match
    has = match.any(dim=-1)
    local_pos = torch.where(has, pos1d.gather(1, src), -1).to(torch.int32)
    return src, has, local_pos


def _ring_from_prefill(k: torch.Tensor, src: torch.Tensor,
                       has: torch.Tensor) -> torch.Tensor:
    """Gather (..., B, S, Hkv, D) into the ring layout (..., B, w, Hkv, D)
    by ``_ring_select``'s placement; leading stacked axes are kept, empty
    rows are zeros (their position is −1)."""
    b, w = src.shape
    shape_idx = (1,) * (k.dim() - 4) + (b, w, 1, 1)
    idx = src.reshape(shape_idx).expand(k.shape[:-3] + (w,) + k.shape[-2:])
    out = torch.gather(k, k.dim() - 3, idx)
    return torch.where(has.reshape(shape_idx), out, out.new_zeros(()))


def _cache_from_prefill(cfg: ArchConfig, caches, positions: torch.Tensor,
                        policy: Optional[PrecisionPolicy] = None) -> Cache:
    """The decode cache from a prefill's collected K/V (or SSM states):
    contiguous leaves and ``full_pos`` for the full-attention layers, the
    rings (``_ring_select``) and ``local_pos`` for the windowed ones, all
    by the temporal stream of M-RoPE positions (``transformer.py:817``);
    then the K/V leaves in the policy's representation."""
    kind = _pattern(cfg)
    if positions.dim() == 3:
        positions = positions[..., 0]
    positions = positions.to(torch.int32)
    if kind == "uniform_ssm":
        return {"ssm": caches["ssm"]}
    if kind in ("uniform_dense", "uniform_moe"):
        cache = {"k": caches["k"], "v": caches["v"], "full_pos": positions}
    elif kind == "hybrid":
        cache = {"ssm": caches["ssm"], "attn_k": caches["attn_k"],
                 "attn_v": caches["attn_v"], "full_pos": positions}
    else:
        src, has, local_pos = _ring_select(positions, cfg.sliding_window)
        cache = {key: _ring_from_prefill(caches[key], src, has)
                 for key in ("local_k", "local_v")}
        cache["global_k"], cache["global_v"] = (caches["global_k"],
                                                caches["global_v"])
        for key in ("tail_k", "tail_v"):
            if key in caches:
                cache[key] = _ring_from_prefill(caches[key], src, has)
        cache["full_pos"] = positions
        cache["local_pos"] = local_pos
    # quantized after the ring is gathered (a gather commutes with the
    # per-entry quantization), so one path covers every layout; the SSM
    # state stays float
    return {key: (maybe_quant_kv(policy, val)
                  if key.split("_")[-1] in ("k", "v")
                  else val if key == "ssm" else val.contiguous())
            for key, val in cache.items()}


def _grow_axis(t: torch.Tensor, axis: int, extra: int,
               value: float = 0) -> torch.Tensor:
    pad = [0, 0] * (t.dim() - axis % t.dim() - 1) + [0, extra]
    return F.pad(t, pad, value=value)


def grow_cache(cfg: ArchConfig, cache: Cache, extra: int) -> Cache:
    """The cache with ``extra`` more rows on the full-attention leaves
    (zeros, positions −1), to decode into; rings and SSM states keep their
    size."""
    out = dict(cache)
    for key in ("k", "v", "global_k", "global_v", "attn_k", "attn_v"):
        if key in out:
            leaf = out[key]
            out[key] = (Int8KV(_grow_axis(leaf.q, -3, extra),
                               _grow_axis(leaf.scale, -2, extra))
                        if isinstance(leaf, Int8KV)
                        else _grow_axis(leaf, -3, extra))
    if "full_pos" in out:
        out["full_pos"] = _grow_axis(out["full_pos"], -1, extra, -1)
    return out
