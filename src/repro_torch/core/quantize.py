"""int8 serving quantization (paper C5): the precision policy, quantized
weights and KV caches, and the dynamic activation quantizer.

The counterpart of ``repro.core.quantize``'s serving half.  Rounding is
half-to-even (``torch.round``, as ``jnp.round``) and every scale is
computed in float32 in the same order as the JAX package, so the int8
values and the scales come out bitwise equal to its own.

One layout differs: a ``QTensor``'s values are stored **(..., N, K)**,
output channel first, so the int8 kernel reads each weight column with
its contraction axis contiguous.  ``quantize_model_params`` and
``params_from_numpy`` transpose once when they build it; the scales stay
(..., N).

Calibrated activation ranges (``AmaxObserver``, ``attach_act_amax``) are
post-training calibration, which comes with port slice 4.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# ---------------------------------------------------------------------------
# PrecisionPolicy: the knob the serving stack threads end to end
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How params, activations and the KV cache are represented.

    ``weights``      "float" | "int8": int8 wraps projection weights in
                     ``QTensor`` (per-output-channel symmetric int8).
    ``activations``  "dynamic": each matmul input row is quantized from
                     its own amax.  ("calibrated" comes with slice 4.)
    ``kv_cache``     "float" | "int8": int8 stores the decode cache as
                     ``Int8KV`` (int8 values + per-(entry, head) f32
                     scales).
    ``compute``      "native" | "fake_quant": native runs the int8
                     kernels; fake_quant runs the same quantization
                     decisions in float (the token-exactness oracle).
    """
    weights: str = "float"
    activations: str = "dynamic"
    kv_cache: str = "float"
    compute: str = "native"

    def __post_init__(self):
        if self.activations == "calibrated":
            raise NotImplementedError(
                "activations='calibrated' (PTQ calibration) comes with port"
                " slice 4")
        for name, allowed in (("weights", ("float", "int8")),
                              ("activations", ("dynamic",)),
                              ("kv_cache", ("float", "int8")),
                              ("compute", ("native", "fake_quant"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: one of"
                                 f" {allowed}")


FLOAT = PrecisionPolicy()
INT8 = PrecisionPolicy(weights="int8", kv_cache="int8")
INT8_FAKEQUANT = dataclasses.replace(INT8, compute="fake_quant")

_POLICIES = {"float": FLOAT, "int8": INT8, "int8_fakequant": INT8_FAKEQUANT}


def policy_for(name) -> PrecisionPolicy:
    """Resolve a CLI-level precision name (or pass a policy through)."""
    if isinstance(name, PrecisionPolicy):
        return name
    if name not in _POLICIES:
        raise ValueError(f"unknown precision {name!r}; "
                         f"one of {sorted(_POLICIES)}")
    return _POLICIES[name]


class QTensor(NamedTuple):
    """A quantized weight: ``q`` (..., N, K) int8 values, output channel
    first, and ``scale`` (..., N) f32 per-output-channel scales.  Leading
    dims are stacked layers."""
    q: torch.Tensor
    scale: torch.Tensor


class Int8KV(NamedTuple):
    """An int8 KV-cache tensor: ``q`` (..., B, S, H, D) int8 values and
    ``scale`` (..., B, S, H) f32, one per cache entry per head."""
    q: torch.Tensor
    scale: torch.Tensor


def _symmetric(x32: torch.Tensor, amax: torch.Tensor, axis: int):
    """int8 values and f32 scales of ``x32`` against ``amax`` broadcast
    back along ``axis``: scale = max(amax, 1e-8) / 127, q = clip(round(x /
    scale), ±127), the JAX package's arithmetic step for step."""
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Dynamic activation quantization (per-row symmetric: the serving path)
# ---------------------------------------------------------------------------
def quant_dynamic(x: torch.Tensor):
    """Symmetric int8 per-row quantization of a matmul input.

    x: (..., K) float.  Each row gets its own scale from its amax, so the
    int8 matmul's per-row x per-channel dequant is exact.  Returns
    (q int8 (..., K), scale f32 (...,)).
    """
    x32 = x.float()
    return _symmetric(x32, x32.abs().amax(dim=-1), -1)


# ---------------------------------------------------------------------------
# KV-cache quantization (per-entry, per-head vector scales)
# ---------------------------------------------------------------------------
def quant_kv(x: torch.Tensor) -> Int8KV:
    """Quantize a KV tensor (..., H, D): one symmetric scale per (entry,
    head) vector of length D."""
    x32 = x.float()
    return Int8KV(*_symmetric(x32, x32.abs().amax(dim=-1), -1))


def dequant_kv(kv: Int8KV, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    return (kv.q.float() * kv.scale[..., None]).to(dtype)


def maybe_quant_kv(policy: Optional[PrecisionPolicy], x: torch.Tensor):
    """Apply the policy's KV-cache representation to a float KV tensor:
    Int8KV (native), quantize-dequantize float (fake_quant), or as is."""
    if policy is None or policy.kv_cache != "int8":
        return x
    kv = quant_kv(x)
    if policy.compute == "fake_quant":
        return dequant_kv(kv, x.dtype)
    return kv


def is_int8_kv_fakequant(policy: Optional[PrecisionPolicy]) -> bool:
    """A float cache that mirrors the int8 cache's numerics: the K/V rows
    go through the quantize-dequantize round trip before they are
    written."""
    return (policy is not None and policy.kv_cache == "int8"
            and policy.compute == "fake_quant")


# ---------------------------------------------------------------------------
# Model-param quantization for the serving path (QTensor leaves)
# ---------------------------------------------------------------------------
# Param sub-trees whose 2-D+ leaves feed ``ops.quant_matmul``; embed and
# unembed stay float so logits keep full precision.
QUANT_SCOPES = ("attn", "mlp", "xattn")


def _leaf_qtensor(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8 over the contraction axis (-2) of
    a (..., K, N) weight, keeping per-layer scales for stacked leaves.
    The values come back transposed to (..., N, K)."""
    amax = w.float().abs().amax(dim=-2)
    q, scale = _symmetric(w.float(), amax, -2)
    return QTensor(q.transpose(-1, -2).contiguous(), scale)


def quantize_model_params(params, policy: PrecisionPolicy = INT8):
    """Wrap every projection weight consumed by ``ops.quant_matmul`` in a
    ``QTensor``.  Leaves outside ``QUANT_SCOPES`` (embeddings, norms) pass
    through untouched.  ``params`` is a ``ParamTree``; so is the result
    (it shares the untouched leaves' storage)."""
    if policy.weights != "int8":
        return params
    from repro_torch.models.params import ParamTree

    def wrap(tree, in_scope: bool):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = wrap(leaf, in_scope or key in QUANT_SCOPES)
            elif (in_scope and isinstance(leaf, torch.Tensor)
                  and leaf.dim() >= 2 and leaf.is_floating_point()):
                out[key] = _leaf_qtensor(leaf.detach())
            else:
                out[key] = leaf.detach() if isinstance(
                    leaf, torch.Tensor) else leaf
        return out

    return ParamTree(wrap(params.tree(), False))
