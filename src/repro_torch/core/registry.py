"""Platform registry: every selectable architecture and block, one place.

``--arch`` on any launcher resolves here; the paper's own evaluation
models are registered alongside the assigned LM pool, so the platform
treats a 26k-param DS-CNN and a 132B MoE as rows of the same table.  The
counterpart of ``repro.core.registry``: the architectures the port serves
(``configs.PORTED``) have the JAX package's rows; every other one names
the port slice that brings it.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch import configs
from repro_torch.core.arch import SHAPES, ArchConfig

PAPER_MODELS = ["ds-cnn", "mobilenetv1", "cifar-cnn", "conv1d-stack"]
DSP_BLOCKS = ["mfe", "mfcc", "spectrogram", "raw", "image_norm"]


def list_architectures() -> List[str]:
    return list(configs.ALIASES)


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    return configs.get_smoke(arch_id) if smoke else configs.get(arch_id)


def list_shapes() -> List[str]:
    return list(SHAPES)


def describe() -> Dict[str, object]:
    """One row per architecture: the config's widths where the port has
    it, else ``{"comes_with": <the port slice>}``."""
    out: Dict[str, object] = {}
    for arch in list_architectures():
        later = configs.comes_with(arch)
        if later is not None:
            out[arch] = {"comes_with": later}
            continue
        cfg = configs.get(arch)
        out[arch] = {
            "family": cfg.family, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size,
            "experts": cfg.n_experts or None,
            "ssm": cfg.ssm_variant or None,
        }
    return out
