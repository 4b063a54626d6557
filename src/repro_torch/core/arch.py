"""Architecture configuration: the single source of truth for a backbone.

The PyTorch counterpart of ``repro.core.arch``: the same fields and
derived quantities, so a config compares equal field for field with the
JAX package's.  ``activation_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

# Families. "dense"/"moe"/"hybrid"/"ssm" use the decoder-only backbone;
# "audio" uses the encoder-decoder backbone; "vlm" is decoder-only with an
# embedding-injection frontend stub; "cnn" covers the paper's eval models.
FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm", "cnn")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str

    # Transformer trunk.
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    tie_embeddings: bool = False

    # Mixture of experts.
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # State-space (mamba) blocks.
    ssm_state: int = 0
    ssm_variant: str = ""             # "mamba1" | "mamba2"
    ssm_expand: int = 2
    d_conv: int = 4
    ssm_heads: int = 0                # mamba2 only; 0 -> d_inner // 64
    attn_every: int = 0               # zamba2: shared attn block every k layers

    # Attention pattern.
    sliding_window: int = 0           # >0 enables sliding-window layers
    local_global_ratio: int = 0       # e.g. 5 -> 5 local : 1 global
    rope_variant: str = "rope"        # "rope" | "mrope"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w head_dim split

    # Encoder-decoder.
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq_divisor: int = 4          # enc_seq = seq // divisor (conv subsample)

    # Modality frontend stub ("" | "audio" | "vision").
    frontend: str = ""

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 2048

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "cnn" and self.d_model <= 0:
            raise ValueError(f"{self.name}: d_model must be positive")

    # Derived quantities -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(self.d_inner // 64, 1)

    @property
    def activation_dtype(self):
        return getattr(torch, self.dtype)

    def padded_vocab(self, multiple: Optional[int] = None) -> int:
        """Vocab rounded up so it shards over the model axis and tiles the MXU.

        Real frameworks (MaxText, Megatron) pad the embedding table; logits
        over pad columns are masked to -inf in the loss.
        """
        if multiple is None:
            multiple = self.vocab_pad_multiple
        if self.vocab_size == 0:
            return 0
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm" and self.n_heads > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md long_500k policy)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # Sliding-window-dominant patterns (gemma3 5:1 local:global).
        return self.sliding_window > 0 and self.local_global_ratio > 0

    # Parameter counting (used by estimator + roofline MODEL_FLOPS) ------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count of the backbone (embeddings included)."""
        if self.family == "cnn":
            return 0  # CNN configs carry their own count via the model def.
        d, h = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * h
        n_kv = self.n_kv_heads * h
        attn = d * n_q + 2 * d * n_kv + n_q * d  # wq wk wv wo
        mlp_dense = 3 * d * self.d_ff            # SwiGLU: gate, up, down
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._mamba_params()
        elif self.family == "hybrid":
            per_layer = self._mamba_params()
            # Shared attention block amortized over layers it serves.
            shared = attn + mlp_dense
            n_attn = self.n_layers // max(self.attn_every, 1)
            total_shared = shared  # weights are SHARED -> count once
            base = self.n_layers * per_layer + total_shared + n_attn * 0
            emb = self.padded_vocab() * d * (1 if self.tie_embeddings else 2)
            return base + emb
        elif self.is_moe:
            n_e = self.n_experts if not active_only else self.experts_per_tok
            per_layer = attn + n_e * mlp_dense + d * self.n_experts  # + router
        else:
            per_layer = attn + mlp_dense
        n_layers = self.n_layers + (self.n_enc_layers if self.is_encdec else 0)
        total = n_layers * per_layer
        if self.is_encdec:  # decoder cross-attention
            total += self.n_layers * attn
        emb = self.padded_vocab() * d * (1 if self.tie_embeddings else 2)
        return total + emb

    def _mamba_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        in_proj = d * 2 * di
        conv = self.d_conv * di
        if self.ssm_variant == "mamba2":
            nh = self.resolved_ssm_heads
            extra = d * 2 * nh * ds + nh  # B,C projections folded + A_log per head
        else:
            dt_rank = max(d // 16, 1)
            extra = di * dt_rank + dt_rank * di + di * ds * 2 + di * ds  # dt, B, C, A
        out_proj = di * d
        return in_proj + conv + extra + out_proj

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (``repro.core.arch.ShapeConfig``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the assigned input-shape cells (``repro.core.arch.SHAPES``)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs: ``long_500k`` only for a
    sub-quadratic arch (``repro.core.arch.shape_applicable``)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("skipped_by_design: pure full-attention arch,"
                       " long_500k needs sub-quadratic")
    return True, ""
