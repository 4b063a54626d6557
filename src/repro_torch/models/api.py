"""Model API: the entry points of a config's family, and its inputs.

The counterpart of ``repro.models.api.ModelFns`` on the port's paths:
training, one-shot prefill, decode and chunk prefill, in the JAX order,
for the uniform dense and MoE decoders, the local:global sliding-window trunk
(gemma3), (prefill and serving only) the mamba1 trunk of the ``ssm``
family and the hybrid trunk (zamba2), and the encoder-decoder backbone
(seamless-m4t, ``models/encdec.py``).  ``input_shapes`` and
``synthetic_inputs`` are the counterparts of ``train_input_specs``,
``prefill_input_specs`` and ``synthetic_inputs``: an enc-dec batch
brings the audio frontend's stand-in, precomputed frame embeddings of
(B, S // ``enc_seq_divisor``, d); a frontend decoder's (qwen2-vl) brings
the vision frontend's, precomputed patch embeddings (B, S, d) in place
of tokens, and under M-RoPE its (B, S, 3) position streams.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.models import encdec, transformer


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
