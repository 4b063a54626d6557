"""Model API: the entry points of a config's family, and its inputs.

The counterpart of ``repro.models.api.ModelFns`` on the port's paths:
training, one-shot prefill, decode and chunk prefill, in the JAX order,
for every trunk: the uniform dense and MoE decoders, the local:global
sliding-window trunk (gemma3), the mamba1 trunk of the ``ssm`` family,
the hybrid trunk (zamba2) and the encoder-decoder backbone (seamless-m4t,
``models/encdec.py``).  ``input_shapes`` and ``synthetic_inputs`` give a
batch's shapes and random values: an enc-dec batch brings the audio
frontend's stand-in, precomputed frame embeddings of (B, S //
``enc_seq_divisor``, d); a frontend decoder's (qwen2-vl) brings the vision
frontend's, precomputed patch embeddings (B, S, d) in place of tokens,
and under M-RoPE its (B, S, 3) position streams.  ``input_specs``
(``train_input_specs``, ``prefill_input_specs``, ``decode_input_specs``)
and ``abstract_cache`` give a shape cell's inputs as tensors on the
``meta`` device for the dry run, and ``input_logical_axes`` their
logical axis names.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.params import abstract_params


class ModelFns(NamedTuple):
    forward_train: Callable
    forward_prefill: Callable
    forward_decode: Callable
    forward_prefill_chunk: Callable


def model_fns(cfg: ArchConfig) -> ModelFns:
    if cfg.is_encdec:
        return ModelFns(encdec.forward_train, encdec.forward_prefill,
                        encdec.forward_decode, encdec.forward_prefill_chunk)
    return ModelFns(transformer.forward_train, transformer.forward_prefill,
                    transformer.forward_decode,
                    transformer.forward_prefill_chunk)


def input_shapes(cfg: ArchConfig, batch: int, seq: int, train: bool = True
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Each input of a training (``train``) or prefill batch of ``batch``
    rows of ``seq`` tokens: name -> (shape, dtype), in the JAX package's
    order (``api.py:43-56``)."""
    shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if train:
        shapes["labels"] = ((batch, seq), torch.int32)
    if cfg.is_encdec:
        shapes["enc_embeddings"] = (
            (batch, seq // cfg.enc_seq_divisor, cfg.d_model),
            cfg.activation_dtype)
    elif cfg.frontend:
        shapes["embeddings"] = ((batch, seq, cfg.d_model),
                                cfg.activation_dtype)
        if cfg.rope_variant == "mrope":
            shapes["positions"] = ((batch, seq, 3), torch.int32)
        return shapes
    shapes["tokens"] = ((batch, seq), torch.int32)
    return shapes


# ---------------------------------------------------------------------------
# Abstract inputs of a shape cell (tensors on the ``meta`` device: shapes
# and dtypes, no memory), as the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    return {name: _sds(s, dt) for name, (s, dt) in input_shapes(
        cfg, shape.global_batch, shape.seq_len, train=True).items()}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig
                        ) -> Dict[str, torch.Tensor]:
    return {name: _sds(s, dt) for name, (s, dt) in input_shapes(
        cfg, shape.global_batch, shape.seq_len, train=False).items()}


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig
                       ) -> Dict[str, object]:
    """Decode is one new token against a cache of ``seq_len``: {"cache":
    the abstract cache, "token": (B,) int32, "position": (B,) int32}."""
    b = shape.global_batch
    return {"cache": abstract_cache(cfg, shape),
            "token": _sds((b,), torch.int32),
            "position": _sds((b,), torch.int32)}


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, policy=None):
    """The cache the one-shot prefill of ``shape`` builds, traced on the
    ``meta`` device (the reference's ``jax.eval_shape`` of its prefill):
    the same leaves and structure as a real prefill's, no memory.  Under
    an int8 ``policy`` the K/V leaves are ``Int8KV`` pairs; the weights
    stay float."""
    fns = model_fns(cfg)
    _, cache = fns.forward_prefill(cfg, abstract_params(cfg),
                                   prefill_input_specs(cfg, shape), policy)
    return cache


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, object]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    raise ValueError(shape.kind)


def input_logical_axes(cfg: ArchConfig, shape: ShapeConfig):
    """Each input's logical axis names, for the sharding rules; None for a
    decode cell (its cache is placed by ``launch/dryrun.py``'s
    ``cache_shardings``)."""
    if shape.kind == "decode":
        return None
    axes = {}
    for name in input_shapes(cfg, 1, 1, train=shape.kind == "train"):
        if name in ("tokens", "labels"):
            axes[name] = ("act_batch", "act_seq")
        elif name == "positions":
            axes[name] = ("act_batch", "act_seq", None)
        elif name in ("embeddings", "enc_embeddings"):
            axes[name] = ("act_batch", "act_seq", "act_dmodel")
    return axes


def synthetic_inputs(cfg: ArchConfig, batch: int, seq: int,
                     generator: torch.Generator, train: bool = True,
                     device: Union[str, torch.device, None] = None
                     ) -> Dict[str, torch.Tensor]:
    """Random inputs of ``input_shapes``, drawn from ``generator`` on
    ``device`` (``cuda`` unless named; the generator lives there too):
    tokens and labels uniform in [0, vocab_size), positions the index in
    each stream, frame and patch embeddings a standard normal in float32,
    cast to the activation dtype, times 0.1 (``api.py:106-123``)."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, dtype) in input_shapes(cfg, batch, seq, train).items():
        if name == "positions":
            out[name] = torch.arange(shape[1], dtype=dtype, device=device)[
                None, :, None].expand(shape).contiguous()
        elif dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, device=device,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    device=device).to(dtype) * 0.1
    return out



def mrope_positions(segments: Sequence[Tuple[str, object]],
                    device: Union[str, torch.device, None] = "cpu"
                    ) -> torch.Tensor:
    """Qwen2-VL's three-stream (temporal, height, width) position ids of
    one sequence, the ids the stub vision frontend stands for: each
    segment is ``("text", n)``, n tokens at the next positions in all three
    streams, or ``("image", (t, h, w))``, a grid of t x h x w patches at
    ``start + (i_t, i_h, i_w)`` (every patch of a frame shares one temporal
    position); the next segment starts one past the largest id so far.
    Returns (S, 3) int32 on ``device``."""
    rows, start = [], 0
    for kind, size in segments:
        if kind == "text":
            ids = start + torch.arange(size)
            rows.append(ids[:, None].expand(size, 3))
            start += size
        elif kind == "image":
            grid = torch.meshgrid(*(torch.arange(n) for n in size),
                                  indexing="ij")
            rows.append(start + torch.stack(grid, -1).reshape(-1, 3))
            start += max(size)
        else:
            raise ValueError(f"unknown segment kind {kind!r}")
    return torch.cat(rows).to(torch.int32).to(device)
