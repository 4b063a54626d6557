"""Model API: the entry points of a config's family.

The counterpart of ``repro.models.api.ModelFns`` on the port's paths:
training, one-shot prefill, decode and chunk prefill, in the JAX order,
for the uniform dense and MoE decoders, the local:global sliding-window trunk
(gemma3) and (prefill and serving only) the mamba1 trunk of the ``ssm``
family and the hybrid trunk (zamba2).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.core.arch import ArchConfig
from repro_torch.models import transformer


class ModelFns(NamedTuple):
    forward_train: Callable
    forward_prefill: Callable
    forward_decode: Callable
    forward_prefill_chunk: Callable


def model_fns(cfg: ArchConfig) -> ModelFns:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder backbone is not ported yet")
    return ModelFns(transformer.forward_train, transformer.forward_prefill,
                    transformer.forward_decode,
                    transformer.forward_prefill_chunk)
