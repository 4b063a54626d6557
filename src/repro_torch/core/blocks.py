"""Impulse blocks (paper C1): the composable pipeline units.

An Edge Impulse project is an ordered block graph: input → DSP block(s)
→ learn block → output.  A block is a small adapter pairing a config with
its functions, so the Impulse can run, evaluate and quantize any
combination.  The counterpart of ``repro.core.blocks``, with the same
registries, names and error messages; a learn block's ``init`` takes a
``torch.Generator`` and a device where the JAX one takes a key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.dsp import blocks as dsp_blocks
from repro_torch.models import kws


@dataclasses.dataclass(frozen=True)
class DSPBlock:
    """Wraps a stateless dsp.blocks.* feature extractor."""
    impl: Any

    @property
    def name(self) -> str:
        return self.impl.name

    def apply(self, raw: torch.Tensor) -> torch.Tensor:
        return self.impl(raw)

    def feature_shape(self, input_shape) -> Tuple[int, ...]:
        return self.impl.feature_shape(input_shape)

    def hyperparams(self) -> Dict[str, Any]:
        return self.impl.hyperparams()


@dataclasses.dataclass(frozen=True)
class LearnBlock:
    """Wraps a model family: cfg + init(cfg, generator, input_shape,
    device) + apply(cfg, params, feats)."""
    cfg: Any
    init_fn: Callable
    apply_fn: Callable

    @property
    def name(self) -> str:
        return self.cfg.name

    def init(self, generator: torch.Generator, input_shape, device=None):
        return self.init_fn(self.cfg, generator, input_shape, device)

    def apply(self, params, feats: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.cfg, params, feats)


# ---------------------------------------------------------------------------
# registry of stock blocks (paper's preset architectures, §4.3) +
# user extensibility (paper §4.9: custom processing / learning blocks)
# ---------------------------------------------------------------------------
_DSP_REGISTRY: Dict[str, Any] = {
    "mfe": dsp_blocks.MFEBlock,
    "mfcc": dsp_blocks.MFCCBlock,
    "spectrogram": dsp_blocks.SpectrogramBlock,
    "raw": dsp_blocks.RawBlock,
    "image_norm": dsp_blocks.ImageNormBlock,
}

_LEARN_REGISTRY: Dict[str, Tuple[Any, Callable, Callable]] = {
    "ds-cnn": (kws.DSCNNConfig, kws.dscnn_init, kws.dscnn_apply),
    "mobilenetv1": (kws.MobileNetV1Config, kws.mobilenetv1_init,
                    kws.mobilenetv1_apply),
    "cifar-cnn": (kws.CifarCNNConfig, kws.cifar_cnn_init,
                  kws.cifar_cnn_apply),
    "conv1d-stack": (kws.Conv1DStackConfig, kws.conv1d_stack_init,
                     kws.conv1d_stack_apply),
}


def register_dsp_block(kind: str, impl_cls) -> None:
    """Custom DSP block (paper §4.9).  ``impl_cls(**hp)`` must provide
    ``name``, ``__call__``, ``feature_shape`` and ``hyperparams``."""
    _DSP_REGISTRY[kind] = impl_cls


def register_learn_block(kind: str, cfg_cls, init_fn, apply_fn) -> None:
    """Custom learn block (paper §4.9): cfg dataclass + init + apply."""
    _LEARN_REGISTRY[kind] = (cfg_cls, init_fn, apply_fn)


def make_dsp_block(kind: str, **hp) -> DSPBlock:
    if kind not in _DSP_REGISTRY:
        raise ValueError(f"unknown dsp block {kind!r}; "
                         f"known: {sorted(_DSP_REGISTRY)}")
    return DSPBlock(_DSP_REGISTRY[kind](**hp))


def make_learn_block(kind: str, **hp) -> LearnBlock:
    if kind not in _LEARN_REGISTRY:
        raise ValueError(f"unknown learn block {kind!r}; "
                         f"known: {sorted(_LEARN_REGISTRY)}")
    cfg_cls, init_fn, apply_fn = _LEARN_REGISTRY[kind]
    return LearnBlock(cfg_cls(**hp), init_fn, apply_fn)
