"""int8 quantization (paper C5): the serving path's precision policy,
quantized weights and KV caches and per-row activation quantizer
(dynamic, or against a calibrated range), the Impulse's post-training
quantization (PTQ) of a parameter tree, and quantization-aware training
(QAT) by straight-through fake quantization.

The counterpart of ``repro.core.quantize``.  Rounding is half-to-even
(``torch.round``, as ``jnp.round``) and every scale is computed in
float32 in the same order as the JAX package, with correctly rounded
divisions on every device, so the int8 values and the scales come out
bitwise equal to its own, on the CPU and on the card.

One layout differs: a ``QTensor``'s values are stored **(..., N, K)**,
output channel first, so the int8 kernel reads each weight column with
its contraction axis contiguous.  ``quantize_model_params`` and
``params_from_numpy`` transpose once when they build it; the scales stay
(..., N), and a calibrated ``amax`` has the stacked prefix ``q.shape[:-2]``
in either layout.

Calibrated activation ranges: ``AmaxObserver``/``calibrate_amax`` fold
representative activations into one amax, ``attach_act_amax`` puts it on
the ``QTensor`` sites by scope name, and ``PrecisionPolicy(activations=
"calibrated")`` makes ``ops.quant_matmul`` quantize each input row
against it (a site with no amax stays dynamic).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import tree

# ---------------------------------------------------------------------------
# PrecisionPolicy: the knob the serving stack threads end to end
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How params, activations and the KV cache are represented.

    ``weights``      "float" | "int8": int8 wraps projection weights in
                     ``QTensor`` (per-output-channel symmetric int8).
    ``activations``  "dynamic" | "calibrated": dynamic quantizes each
                     matmul input row from its own amax; calibrated
                     against the ``QTensor.amax`` recorded from
                     representative batches (``AmaxObserver``), dynamic
                     where no amax was attached.
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
        for name, allowed in (("weights", ("float", "int8")),
                              ("activations", ("dynamic", "calibrated")),
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
    dims are stacked layers.  ``amax`` optionally carries a calibrated
    input-activation amax for this matmul site (0-d, or (L,) for stacked
    layers); None means dynamic activation ranges."""
    q: torch.Tensor
    scale: torch.Tensor
    amax: Optional[torch.Tensor] = None


class Int8KV(NamedTuple):
    """An int8 KV-cache tensor: ``q`` (..., B, S, H, D) int8 values and
    ``scale`` (..., B, S, H) f32, one per cache entry per head."""
    q: torch.Tensor
    scale: torch.Tensor


# Stable names under which ``torch.export`` serializes the trees that hold
# these (a deployed decode step's weights and cache).
pytree._register_namedtuple(
    QTensor, serialized_type_name="repro_torch.core.quantize.QTensor")
pytree._register_namedtuple(
    Int8KV, serialized_type_name="repro_torch.core.quantize.Int8KV")

# 127 as a 0-d tensor per device, made once (no fill kernel per call)
_DIV127: Dict[torch.device, torch.Tensor] = {}


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as one correctly rounded f32 division on every
    device.  The divisor is a tensor on amax's device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    can differ in the last bit from the CPU's and the JAX package's
    quotient."""
    div = _DIV127.get(amax.device)
    if div is None:
        div = _DIV127[amax.device] = torch.full((), 127.0,
                                                device=amax.device)
    return torch.clamp(amax, min=1e-8) / div


def _symmetric(x32: torch.Tensor, amax: torch.Tensor, axis: int):
    """int8 values and f32 scales of ``x32`` against ``amax`` broadcast
    back along ``axis``: scale = max(amax, 1e-8) / 127, q = clip(round(x /
    scale), ±127), the JAX package's arithmetic step for step."""
    scale = _scale_of(amax)
    q = torch.clamp(torch.round(x32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Dynamic activation quantization (per-row symmetric: the serving path)
# ---------------------------------------------------------------------------
def quant_dynamic(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Symmetric int8 per-row quantization of a matmul input.

    x: (..., K) float.  Each row gets its own scale from its amax, so the
    int8 matmul's per-row x per-channel dequant is exact.  ``amax``
    (broadcastable to x.shape[:-1]) substitutes a calibrated range for the
    observed one.  Returns (q int8 (..., K), scale f32 (...,), contiguous).
    """
    x32 = x.float()
    if amax is None:
        row_amax = x32.abs().amax(dim=-1)
    else:
        row_amax = torch.as_tensor(amax, dtype=torch.float32,
                                   device=x.device).expand(x32.shape[:-1])
    q, scale = _symmetric(x32, row_amax, -1)
    return q, scale.contiguous()


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
    The values come back transposed to (..., N, K).  A stacked leaf is
    quantized one layer at a time (the same arithmetic: every scale is a
    layer's own), so the f32 temporaries are one layer's, not the
    stack's (a 16-layer stack of qwen2-vl's (8192, 29568) weights would
    take four f32 copies of 15.5 GB)."""
    if w.dim() > 2:
        parts = [_leaf_qtensor(layer) for layer in w]
        return QTensor(torch.stack([p.q for p in parts]),
                       torch.stack([p.scale for p in parts]))
    amax = w.float().abs().amax(dim=-2)
    q, scale = _symmetric(w.float(), amax, -2)
    return QTensor(q.transpose(-1, -2).contiguous(), scale)


def quantize_model_params(params, policy: PrecisionPolicy = INT8):
    """Wrap every projection weight consumed by ``ops.quant_matmul`` in a
    ``QTensor``.  Leaves outside ``QUANT_SCOPES`` (embeddings, norms), and
    leaves that already are ``QTensor``s (a quantized tree, its calibrated
    amax attached), pass through untouched.  ``params`` is a ``ParamTree``; so is the result
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


def attach_act_amax(qparams, amax_by_scope: Dict[str, Any]):
    """Attach calibrated activation amax values to the ``QTensor`` sites,
    keyed by their innermost scope or leaf name (e.g. ``{"wq": 3.1,
    "w_down": 8.2}`` or coarser ``{"attn": 3.5}``).  Unmatched sites keep
    dynamic ranges.

    The amax is broadcast to the leaf's stacked prefix (``q.shape[:-2]``)
    on the leaf's device, so the per-layer views of a stacked leaf carry
    their layer's value; a per-layer array of that shape passes through as
    it is.  ``qparams`` is a ``ParamTree`` (so is the result, sharing the
    leaves' storage) or a nested dict."""
    from repro_torch.models.params import ParamTree

    def attach(leaf: QTensor, path) -> QTensor:
        for name in reversed(path):
            if name in amax_by_scope:
                amax = torch.as_tensor(amax_by_scope[name],
                                       dtype=torch.float32,
                                       device=leaf.q.device)
                return leaf._replace(
                    amax=amax.expand(leaf.q.shape[:-2]).contiguous())
        return leaf

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return attach(t, path) if isinstance(t, QTensor) else t

    if isinstance(qparams, ParamTree):
        return ParamTree(walk(qparams.tree(), ()))
    return walk(qparams, ())


@dataclasses.dataclass
class AmaxObserver:
    """Running activation amax over representative batches (paper C5's
    calibration step).  ``momentum=None`` tracks the running max;
    otherwise an EMA, which is robust to outlier batches."""
    momentum: Optional[float] = None
    amax: Optional[float] = None

    def update(self, x) -> float:
        cur = float(torch.as_tensor(x).abs().max())
        if self.amax is None:
            self.amax = cur
        elif self.momentum is None:
            self.amax = max(self.amax, cur)
        else:
            self.amax = self.momentum * self.amax + (1 - self.momentum) * cur
        return self.amax


def calibrate_amax(batches, momentum: Optional[float] = None) -> float:
    """Fold representative batches into one calibrated amax."""
    obs = AmaxObserver(momentum=momentum)
    for x in batches:
        obs.update(x)
    if obs.amax is None:
        raise ValueError("no calibration batches given")
    return obs.amax


# ---------------------------------------------------------------------------
# PTQ of an Impulse's parameter tree (per-output-channel symmetric int8)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class QuantizedParams:
    q: Any           # tree of int8 tensors (or passthrough float leaves)
    scales: Any      # matching tree of f32 scales (None = not quantized)
    meta: Dict[str, Any]


def _quant_leaf(w: torch.Tensor):
    """Per-output-channel symmetric int8 for >= 2-D float leaves; the last
    axis is the output channel (the JAX layouts: HWIO, WIO, (in, out)).
    Returns (q, scale) with scale keeping w's rank, or (w, None)."""
    if w.dim() < 2 or not w.is_floating_point():
        return w, None
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = _scale_of(amax)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequant_leaf(q, scale):
    if scale is None:
        return q
    return q.float() * scale


def quantize_params(params) -> QuantizedParams:
    """Weight-only PTQ of a parameter tree: ``q`` and ``scales`` have its
    structure.  Activations stay float (the JAX package's ``calib_fn`` is
    never called there, so the port takes none).  ``meta`` counts the
    leaves quantized and the bytes before and after, as the JAX package
    does."""
    meta = {"n_quantized": 0, "float_bytes": 0, "int8_bytes": 0}

    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return ({k: a for k, (a, _) in parts.items()},
                    {k: b for k, (_, b) in parts.items()})
        if isinstance(t, (list, tuple)):
            parts = [split(v) for v in t]
            return (type(t)(a for a, _ in parts),
                    type(t)(b for _, b in parts))
        q, scale = _quant_leaf(t)
        meta["float_bytes"] += t.numel() * t.element_size()
        if scale is None:
            meta["int8_bytes"] += t.numel() * t.element_size()
        else:
            meta["n_quantized"] += 1
            meta["int8_bytes"] += q.numel() + scale.numel() * 4
        return q, scale

    qs, ss = split(params)
    meta["compression"] = meta["float_bytes"] / max(meta["int8_bytes"], 1)
    return QuantizedParams(qs, ss, meta)


def fake_quant_params(qp: QuantizedParams):
    """The float tree the int8 weights stand for: q * scale per quantized
    leaf, the other leaves as they are."""
    return tree.map_tree(_dequant_leaf, qp.q, qp.scales)


def quantization_error(params, qp: QuantizedParams) -> float:
    """Largest |w - dequant(quant(w))| over every leaf."""
    errs = tree.map_tree(
        lambda a, b: float((a.float() - b.float()).abs().max()),
        params, fake_quant_params(qp))
    return max(tree.leaves(errs))


# ---------------------------------------------------------------------------
# QAT: straight-through-estimator fake quant for training
# ---------------------------------------------------------------------------
def fake_quant_ste(w: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with an identity gradient (STE): the values of
    ``_dequant_leaf(_quant_leaf(w))``, the gradient of ``w``."""
    q, scale = _quant_leaf(w.detach())
    if scale is None:
        return w
    return w + (_dequant_leaf(q, scale) - w).detach()


def qat_params(params):
    """STE fake quant of every quantizable leaf (wrap a loss with this for
    quantization-aware training)."""
    return tree.map_tree(fake_quant_ste, params)


# ---------------------------------------------------------------------------
# Activation quantization helpers (per-tensor affine)
# ---------------------------------------------------------------------------
def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-d f32 tensor on ``like``'s device: an
    operation with it rounds once in f32 on every device (the card's
    division by a Python scalar multiplies by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def calibrate_activation(x) -> Dict[str, float]:
    """Per-tensor affine int8 range of ``x``: ``scale`` and ``zero_point``."""
    x = torch.as_tensor(x)
    lo = float(x.min())
    hi = float(x.max())
    scale = max(hi - lo, 1e-8) / 255.0
    zero_point = int(round(-lo / scale)) - 128
    return {"scale": scale, "zero_point": zero_point}


def quant_activation(x: torch.Tensor, c: Dict[str, float]) -> torch.Tensor:
    q = torch.round(x / _f32(c["scale"], x)) + c["zero_point"]
    return torch.clamp(q, -128, 127).to(torch.int8)


def dequant_activation(q: torch.Tensor, c: Dict[str, float]
                       ) -> torch.Tensor:
    return (q.float() - c["zero_point"]) * _f32(c["scale"], q)
