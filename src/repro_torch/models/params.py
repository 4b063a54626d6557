"""Parameter specs and the model's weights as an ``nn.Module``.

Every backbone weight is declared once as a ``ParamSpec`` (shape,
logical axis names and initializer), in the layout of
``repro.models.params``: projection
weights ``(d_in, d_out)`` applied as ``x @ w``, and per-layer leaves
stacked along a leading ``(L, ...)`` axis.  The uniform dense decoder, the
uniform MoE decoder (phi3.5-moe, dbrx: each block's experts a (d, E)
router and (E, d, f) / (E, f, d) banks), the uniform mamba1 trunk
(falcon-mamba), the local:global sliding-window trunk (gemma3), the
hybrid trunk (zamba2: stacked mamba2 groups and one shared, unstacked
attention block) and the encoder-decoder backbone (seamless-m4t: stacked
dense encoder blocks ``enc_blocks`` with ``enc_final_norm``, and decoder
``blocks`` that add a cross-attention ``xattn`` and its ``xattn_norm``)
are declared.  ``init_params``
draws them from a ``torch.Generator`` on the target device;
``params_from_numpy`` carries a tree of numpy arrays (for example the JAX
package's own ``init_params``) across leaf for leaf.  For the dry run,
``abstract_params`` gives the float32 masters on the ``meta`` device (no
memory), ``logical_axes`` each leaf's logical names (the sharding rules'
input) and ``param_count`` the number of weights.

Both return a ``ParamTree``: an ``nn.Module`` whose leaves are
``nn.Parameter``s, indexed like the JAX params dict (``p["blocks"]["attn"]
["wq"]``), so ``state_dict``, ``parameters`` and ``to`` work as usual.  An
int8 projection weight is a ``QTensor`` leaf (``core/quantize.py``): its
values, scales and calibrated amax (if any) are held by a ``QLeaf``
module, and indexing returns the ``QTensor``.  Serving weights are
frozen; ``trainable=True`` gives the training path's masters: every leaf
float32 with ``requires_grad``, as the JAX package keeps its masters
(``ParamSpec.dtype == "float32"``), cast to the activation dtype where
they are used (``quant_matmul``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.core.quantize import QTensor
from repro_torch.core.tree import map_tree


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    # the logical axis names the sharding rules map (``sharding/policy.py``)
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal|zeros|ones|a_log|dt_bias|conv
    scale: float = 0.02

    def stack(self, n: int, axis_name: str = "layers") -> "ParamSpec":
        return dataclasses.replace(self, shape=(n,) + self.shape,
                                   logical=(axis_name,) + self.logical)


SpecTree = Dict[str, object]  # nested dict of ParamSpec


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="zeros")


def attn_specs(cfg: ArchConfig) -> SpecTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return {"wq": ParamSpec((d, nq), ("p_dmodel", "p_heads")),
            "wk": ParamSpec((d, nkv), ("p_dmodel", "p_kv_heads")),
            "wv": ParamSpec((d, nkv), ("p_dmodel", "p_kv_heads")),
            "wo": ParamSpec((nq, d), ("p_heads", "p_dmodel"))}


def mlp_specs(cfg: ArchConfig) -> SpecTree:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": ParamSpec((d, f), ("p_dmodel", "p_ff")),
            "w_up": ParamSpec((d, f), ("p_dmodel", "p_ff")),
            "w_down": ParamSpec((f, d), ("p_ff", "p_ff_in"))}


def moe_specs(cfg: ArchConfig) -> SpecTree:
    """The experts of an MoE block: the (d, E) router and the (E, d, f) /
    (E, f, d) SwiGLU banks."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ParamSpec((d, e), ("p_dmodel", None)),
            "w_gate": ParamSpec((e, d, f), ("p_experts", "p_dmodel", "p_ff")),
            "w_up": ParamSpec((e, d, f), ("p_experts", "p_dmodel", "p_ff")),
            "w_down": ParamSpec((e, f, d),
                                ("p_experts", "p_ff", "p_ff_in"))}


def mamba1_specs(cfg: ArchConfig) -> SpecTree:
    d, di, ds, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    dt_rank = max(d // 16, 1)
    return {"in_proj": ParamSpec((d, 2 * di), ("p_dmodel", "p_dinner")),
            "conv_w": ParamSpec((k, di), ("p_conv", "p_dinner"),
                                init="conv"),
            "conv_b": ParamSpec((di,), ("p_dinner",), init="zeros"),
            "x_dt": ParamSpec((di, dt_rank), ("p_dinner", None)),
            "dt_proj": ParamSpec((dt_rank, di), (None, "p_dinner"),
                                 scale=0.1),
            "dt_bias": ParamSpec((di,), ("p_dinner",), init="dt_bias"),
            "wb": ParamSpec((di, ds), ("p_dinner", "p_state")),
            "wc": ParamSpec((di, ds), ("p_dinner", "p_state")),
            "a_log": ParamSpec((di, ds), ("p_dinner", "p_state"),
                               init="a_log"),
            "d_skip": ParamSpec((di,), ("p_dinner",), init="ones"),
            "out_proj": ParamSpec((di, d), ("p_dinner", "p_dmodel"))}


def mamba2_specs(cfg: ArchConfig) -> SpecTree:
    """The mamba2 (SSD) layer: B, C and dt projected from the block's
    input (``wb``, ``wc``, ``dt_w``), one decay, step bias and skip a head
    (``a_log``, ``dt_bias``, ``d_skip`` of (nh,)), and the gated output's
    norm scale ``gate_norm``."""
    d, di, ds, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    nh = cfg.resolved_ssm_heads
    return {"in_proj": ParamSpec((d, 2 * di), ("p_dmodel", "p_dinner")),
            "conv_w": ParamSpec((k, di), ("p_conv", "p_dinner"),
                                init="conv"),
            "conv_b": ParamSpec((di,), ("p_dinner",), init="zeros"),
            "wb": ParamSpec((d, ds), ("p_dmodel", "p_state")),
            "wc": ParamSpec((d, ds), ("p_dmodel", "p_state")),
            "dt_w": ParamSpec((d, nh), ("p_dmodel", None)),
            "dt_bias": ParamSpec((nh,), (None,), init="dt_bias"),
            "a_log": ParamSpec((nh,), (None,), init="a_log"),
            "d_skip": ParamSpec((nh,), (None,), init="ones"),
            "gate_norm": ParamSpec((di,), ("p_dinner",), init="zeros"),
            "out_proj": ParamSpec((di, d), ("p_dinner", "p_dmodel"))}


def dense_block_specs(cfg: ArchConfig) -> SpecTree:
    return {"attn_norm": _norm(cfg.d_model), "attn": attn_specs(cfg),
            "mlp_norm": _norm(cfg.d_model), "mlp": mlp_specs(cfg)}


def moe_block_specs(cfg: ArchConfig) -> SpecTree:
    return {"attn_norm": _norm(cfg.d_model), "attn": attn_specs(cfg),
            "mlp_norm": _norm(cfg.d_model), "moe": moe_specs(cfg)}


def encoder_block_specs(cfg: ArchConfig) -> SpecTree:
    return dense_block_specs(cfg)


def decoder_xattn_block_specs(cfg: ArchConfig) -> SpecTree:
    """A dense block and a cross-attention over the encoder's output: its
    norm ``xattn_norm`` and projections ``xattn`` (``wk``/``wv`` read the
    encoder's output, ``wq``/``wo`` the decoder's stream)."""
    s = dense_block_specs(cfg)
    s["xattn_norm"] = _norm(cfg.d_model)
    s["xattn"] = attn_specs(cfg)
    return s


_MAMBA_SPECS = {"mamba1": mamba1_specs, "mamba2": mamba2_specs}


def mamba_block_specs(cfg: ArchConfig) -> SpecTree:
    if cfg.ssm_variant not in _MAMBA_SPECS:
        raise ValueError(f"{cfg.name}: unknown ssm_variant"
                         f" {cfg.ssm_variant!r}")
    return {"norm": _norm(cfg.d_model),
            "mamba": _MAMBA_SPECS[cfg.ssm_variant](cfg)}


def _stack_tree(tree: SpecTree, n: int) -> SpecTree:
    return {k: (_stack_tree(v, n) if isinstance(v, dict) else v.stack(n))
            for k, v in tree.items()}


def layer_pattern(cfg: ArchConfig) -> Dict[str, int]:
    """Static grouping of the layers (as ``repro.models.params``)."""
    if cfg.family in ("dense", "vlm") and cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        n_groups = cfg.n_layers // (r + 1)
        tail = cfg.n_layers - n_groups * (r + 1)
        return {"kind": "local_global", "ratio": r, "n_groups": n_groups,
                "tail_local": tail}
    if cfg.family == "hybrid":
        k = cfg.attn_every
        if cfg.n_layers % k:
            raise ValueError(f"n_layers {cfg.n_layers} % attn_every {k}")
        return {"kind": "hybrid", "group": k, "n_groups": cfg.n_layers // k}
    if cfg.family == "ssm":
        return {"kind": "uniform_ssm", "n_layers": cfg.n_layers}
    if cfg.is_moe:
        return {"kind": "uniform_moe", "n_layers": cfg.n_layers}
    return {"kind": "uniform_dense", "n_layers": cfg.n_layers}


def _uniform_specs(cfg: ArchConfig, pat, block) -> SpecTree:
    return {"blocks": _stack_tree(block(cfg), pat["n_layers"])}


def local_global_specs(cfg: ArchConfig, pat) -> SpecTree:
    """The sliding-window trunk (gemma3): ``groups.local`` (n_groups,
    ratio, ...) of windowed blocks, each group closed by one full-attention
    block of ``groups.global`` (n_groups, ...), then ``tail_local`` (the
    layers left over, windowed) where there are any."""
    block = dense_block_specs(cfg)
    specs: SpecTree = {"groups": {
        "local": _stack_tree(_stack_tree(block, pat["ratio"]),
                             pat["n_groups"]),
        "global": _stack_tree(block, pat["n_groups"])}}
    if pat["tail_local"]:
        specs["tail_local"] = _stack_tree(block, pat["tail_local"])
    return specs


def hybrid_specs(cfg: ArchConfig, pat) -> SpecTree:
    """The hybrid trunk (zamba2): ``groups`` (n_groups, group, ...) of
    mamba2 blocks, and one dense block ``shared_attn``, unstacked: its
    weights serve the block that closes every group."""
    return {"groups": _stack_tree(_stack_tree(mamba_block_specs(cfg),
                                              pat["group"]),
                                  pat["n_groups"]),
            "shared_attn": dense_block_specs(cfg)}


_BLOCK_SPECS = {
    "uniform_dense": lambda cfg, pat: _uniform_specs(cfg, pat,
                                                     dense_block_specs),
    "uniform_ssm": lambda cfg, pat: _uniform_specs(cfg, pat,
                                                   mamba_block_specs),
    "uniform_moe": lambda cfg, pat: _uniform_specs(cfg, pat,
                                                   moe_block_specs),
    "local_global": local_global_specs,
    "hybrid": hybrid_specs,
}


def encdec_specs(cfg: ArchConfig) -> SpecTree:
    """The encoder-decoder backbone: ``enc_blocks`` (n_enc_layers, ...) of
    dense blocks and ``enc_final_norm``, and decoder ``blocks`` (n_layers,
    ...) with cross-attention."""
    return {"enc_blocks": _stack_tree(encoder_block_specs(cfg),
                                      cfg.n_enc_layers),
            "enc_final_norm": _norm(cfg.d_model),
            "blocks": _stack_tree(decoder_xattn_block_specs(cfg),
                                  cfg.n_layers)}


def build_specs(cfg: ArchConfig) -> SpecTree:
    pat = layer_pattern(cfg)
    if pat["kind"] not in _BLOCK_SPECS or (
            cfg.is_encdec and pat["kind"] != "uniform_dense"):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {pat['kind']!r} is not ported yet"
            " (the port has the uniform dense, uniform MoE, uniform mamba1,"
            " local:global and hybrid trunks, and the dense enc-dec)")
    d, vpad = cfg.d_model, cfg.padded_vocab()
    specs: SpecTree = {"embed": ParamSpec((vpad, d), ("p_vocab", "p_dmodel")),
                       "final_norm": _norm(d)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((vpad, d), ("p_vocab", "p_dmodel"))
    specs.update(encdec_specs(cfg) if cfg.is_encdec
                 else _BLOCK_SPECS[pat["kind"]](cfg, pat))
    return specs


def _map_specs(fn, tree: SpecTree) -> Dict[str, object]:
    # sorted keys: the leaf order of jax.tree.flatten
    return {k: (_map_specs(fn, tree[k]) if isinstance(tree[k], dict)
                else fn(tree[k])) for k in sorted(tree)}


def logical_axes(cfg: ArchConfig) -> Dict[str, object]:
    """The tree of each weight's logical axis names (``layers`` on a
    stacked axis), the input of ``sharding.policy.params_pspecs``."""
    return _map_specs(lambda spec: spec.logical, build_specs(cfg))


def param_count(cfg: ArchConfig) -> int:
    """The number of weights the spec tree declares."""
    specs = []
    _map_specs(specs.append, build_specs(cfg))
    return sum(int(np.prod(spec.shape)) for spec in specs)


def abstract_params(cfg: ArchConfig, trainable: bool = False
                    ) -> "ParamTree":
    """The weights' shapes and dtypes without memory: a ``ParamTree`` of
    float32 tensors on the ``meta`` device (the port's
    ``ShapeDtypeStruct``), every leaf float32 as the reference's masters
    (``ParamSpec.dtype``); ``trainable`` leaves take gradients, so a train
    step traces on them (``launch/dryrun.py``)."""
    return ParamTree(_map_specs(
        lambda spec: torch.empty(spec.shape, dtype=torch.float32,
                                 device="meta"), build_specs(cfg)), trainable)


# ---------------------------------------------------------------------------
# The weights as a module
# ---------------------------------------------------------------------------
class QLeaf(nn.Module):
    """The frozen tensors of a ``QTensor`` leaf: values, scales and, where
    one was attached, the calibrated activation amax."""

    def __init__(self, qt: QTensor):
        super().__init__()
        self.q = nn.Parameter(qt.q, requires_grad=False)
        self.scale = nn.Parameter(qt.scale, requires_grad=False)
        self.amax = None if qt.amax is None else nn.Parameter(
            qt.amax, requires_grad=False)

    def qtensor(self) -> QTensor:
        return QTensor(self.q, self.scale, self.amax)

    def layer(self, i) -> QTensor:
        """Layer i (an index or a tuple of them) of a stacked leaf."""
        return QTensor(self.q[i], self.scale[i],
                       None if self.amax is None else self.amax[i])


class ParamTree(nn.Module):
    """A nested tree of weights, indexed like a dict: frozen, or
    (``trainable``) leaves that take gradients."""

    def __init__(self, tree: Dict[str, object], trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable))
            elif isinstance(val, QTensor):
                if trainable:
                    raise TypeError(f"{key}: an int8 QTensor leaf cannot be"
                                    " trained")
                self.add_module(key, QLeaf(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=trainable))
        self._per_layer: Dict[int, list] = {}

    def __getitem__(self, key: str):
        val = getattr(self, key)
        return val.qtensor() if isinstance(val, QLeaf) else val

    def tree(self) -> Dict[str, object]:
        """The weights as a nested dict of tensors and ``QTensor``s."""
        out: Dict[str, object] = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = mod.qtensor() if isinstance(mod, QLeaf) \
                else mod.tree()
        return out

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def unstack(self, depth: int = 1) -> list:
        """Per-layer views of a stacked ``(L, ...)`` subtree; with ``depth``
        2, of a ``(G, R, ...)`` subtree (the local layers of the sliding-
        window trunk), as a list of G lists of R views.

        Serving (frozen leaves, or no autograd) reuses views made once:
        slicing every leaf on every step costs more host time than the
        layer's kernels take on the card.  Under autograd with trainable
        leaves the views are made anew on each call, one ``unbind`` per
        leaf: they carry this forward's graph, the gradients of all L
        layers reach the stacked leaf in one stack, and an in-place
        optimizer update leaves no stale view behind."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            return self._unbound(depth)
        if depth not in self._per_layer:
            shape = next(iter(self.parameters())).shape[:depth]
            self._per_layer[depth] = _grid(shape, self._slice)
        return self._per_layer[depth]

    def _apply(self, fn, recurse=True):
        self._per_layer = {}        # moved or cast weights: views are stale
        return super()._apply(fn, recurse)

    def _unbound(self, depth: int = 1) -> list:
        shape = next(iter(self.parameters())).shape[:depth]
        layers = _grid(shape, lambda idx: {})
        for k, p in self._parameters.items():
            views = _grid(shape, lambda idx: None)
            _unbind_into(views, p, depth)
            for idx in itertools.product(*map(range, shape)):
                _at(layers, idx)[k] = _at(views, idx)
        for k, m in self._modules.items():
            sub = m._unbound(depth)
            for idx in itertools.product(*map(range, shape)):
                _at(layers, idx)[k] = _at(sub, idx)
        return layers

    def _slice(self, idx: Tuple[int, ...]) -> Dict[str, object]:
        out: Dict[str, object] = {k: p[idx]
                                  for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = m.layer(idx) if isinstance(m, QLeaf) else m._slice(idx)
        return out


def _grid(shape, fn, prefix: Tuple[int, ...] = ()) -> list:
    """``fn(idx)`` for every index of ``shape``, as nested lists."""
    if len(shape) == 1:
        return [fn(prefix + (i,)) for i in range(shape[0])]
    return [_grid(shape[1:], fn, prefix + (i,)) for i in range(shape[0])]


def _at(grid: list, idx: Tuple[int, ...]):
    for i in idx[:-1]:
        grid = grid[i]
    return grid[idx[-1]]


def _unbind_into(grid: list, t: torch.Tensor, depth: int) -> None:
    """Fill ``grid`` (nested lists of ``depth`` levels) with the views of
    ``t`` along its leading ``depth`` axes, one ``unbind`` a level."""
    for i, view in enumerate(torch.unbind(t)):
        if depth == 1:
            grid[i] = view
        else:
            _unbind_into(grid[i], view, depth - 1)


class TreeView(dict):
    """A nested dict of weights (``ParamTree.tree()``) read the way the
    model reads a ``ParamTree``: indexing, ``get`` and ``unstack``.  A
    deployed decode step (``core/eon_compiler.py``) takes its weights in
    this form, as inputs of the exported program: the per-layer views are
    then ops of the program, made on every call, not views kept here."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__({k: TreeView(v) if isinstance(v, dict) else v
                          for k, v in tree.items()})

    def unstack(self, depth: int = 1) -> list:
        """Per-layer views of a stacked ``(L, ...)`` subtree (``depth`` 2:
        of a ``(G, R, ...)`` one, as in ``ParamTree.unstack``)."""
        first = next(iter(self.values()))
        while isinstance(first, TreeView):
            first = next(iter(first.values()))
        shape = (first.q if isinstance(first, QTensor) else first).shape
        return _grid(shape[:depth], self._slice)

    def _slice(self, i) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for k, v in self.items():
            if isinstance(v, TreeView):
                out[k] = v._slice(i)
            elif isinstance(v, QTensor):
                out[k] = QTensor(v.q[i], v.scale[i],
                                 None if v.amax is None else v.amax[i])
            else:
                out[k] = v[i]
        return out


# leaves the JAX package's mamba layers read in float32 whatever the
# activation dtype (``ssm.py:128``, ``:161``; mamba2's step bias too,
# ``:226``): they stay float32
F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _leaf_dtype(name: str, ndim: int, dtype: Optional[torch.dtype],
                default: torch.dtype) -> torch.dtype:
    # 1-D leaves (norm scales) and the SSM's dynamics stay float32, as the
    # JAX package's masters; matrices take the working dtype
    if ndim < 2 or name in F32_LEAVES:
        return torch.float32
    return dtype or default


def _draw(spec: ParamSpec, generator: torch.Generator, device
          ) -> torch.Tensor:
    """One leaf in float32 by its initializer, as
    ``repro.models.params._init_one`` draws it (from torch's generator)."""
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if spec.init == "a_log":
        # A = -exp(a_log) = -(1..N) along the state axis (S4D-real)
        base = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                      device=device))
        return base.expand(shape).contiguous()
    if spec.init == "dt_bias":
        # inverse softplus of dt, log-uniform in [1e-3, 0.1] (mamba init)
        u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            float(np.log(1e-3)), float(np.log(0.1)), generator=generator)
        dt = torch.exp(u)
        return dt + torch.log(-torch.expm1(-dt))
    if spec.init == "conv":
        # the bound reads the leading axis, as the JAX package's does (the
        # layer count, once the spec is stacked)
        bound = shape[0] ** -0.5
        return torch.empty(shape, dtype=torch.float32, device=device
                           ).uniform_(-bound, bound, generator=generator)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(spec.scale)


def _draw_by_layer(spec: ParamSpec, generator: torch.Generator, device,
                   dtype: torch.dtype) -> torch.Tensor:
    """A stacked leaf drawn one layer at a time into a tensor of ``dtype``:
    an expert bank's float32 draw of all layers at once would take twice
    its bf16 bytes again (40 GB for one of phi3.5-moe's at 24 layers)."""
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    layer = dataclasses.replace(spec, shape=spec.shape[1:])
    for i in range(spec.shape[0]):
        out[i] = _draw(layer, generator, device)
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: Union[str, torch.device, None] = None,
                dtype: Optional[torch.dtype] = None,
                trainable: bool = False) -> ParamTree:
    """Random weights drawn from ``generator`` on ``device`` (``cuda``
    unless named; the generator must live on the same device), each by its
    spec's initializer: scaled normal, zeros (norms, biases), and the
    mamba layers' ones (D skip), ``a_log``, ``dt_bias`` and ``conv``.
    Matrices are stored in ``dtype`` (default: the config's activation
    dtype; float32 masters when ``trainable``, whose leaves then take
    gradients); 1-D leaves and ``F32_LEAVES`` in float32.  The experts'
    leaves are drawn one layer at a time.  torch's
    generator cannot reproduce ``jax.random``: parity tests carry the JAX
    package's weights across with ``params_from_numpy`` instead."""
    device = resolve_device(device)
    if trainable:
        dtype = dtype or torch.float32

    def build(tree: SpecTree, by_layer: bool = False) -> Dict[str, object]:
        # sorted keys: the leaf order of jax.tree.flatten
        out: Dict[str, object] = {}
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out[k] = build(tree[k], by_layer or k == "moe")
                continue
            spec = tree[k]
            dt = _leaf_dtype(k, len(spec.shape), dtype, cfg.activation_dtype)
            out[k] = (_draw_by_layer(spec, generator, device, dt) if by_layer
                      else _draw(spec, generator, device).to(dt))
        return out

    return ParamTree(build(build_specs(cfg)), trainable)


def params_from_numpy(tree: Dict[str, object],
                      device: Union[str, torch.device, None] = None,
                      dtype: Optional[torch.dtype] = None,
                      trainable: bool = False) -> ParamTree:
    """Carry a nested dict of numpy arrays across as a ``ParamTree`` on
    ``device`` (``cuda`` unless named).  Matrices go to ``dtype`` (default:
    kept as given; float32 masters when ``trainable``, whose leaves then
    take gradients), 1-D leaves and ``F32_LEAVES`` to float32.

    A quantized leaf (any object with ``q`` (..., K, N) int8 and ``scale``
    (..., N) arrays, such as the JAX package's ``QTensor`` mapped to
    numpy) becomes a ``QTensor`` with its values transposed to the port's
    (..., N, K) layout, bit for bit, and its ``amax`` (where it has one)
    in float32."""
    device = resolve_device(device)
    if trainable:
        dtype = dtype or torch.float32

    def conv(x, name: str = "") -> object:
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if hasattr(x, "q") and hasattr(x, "scale"):
            q = torch.from_numpy(np.array(x.q))
            if q.dtype != torch.int8:
                raise TypeError(f"quantized leaf of {q.dtype}, not int8")
            amax = getattr(x, "amax", None)
            return QTensor(
                q.transpose(-1, -2).contiguous().to(device),
                torch.from_numpy(np.array(x.scale, np.float32)).to(device),
                None if amax is None else torch.from_numpy(
                    np.array(amax, np.float32)).to(device))
        t = torch.from_numpy(np.array(x))
        return t.to(device=device, dtype=_leaf_dtype(
            name, t.ndim, dtype, t.dtype)).contiguous()

    return ParamTree(conv(tree), trainable)


def kws_params_from_numpy(params: object,
                          device: Union[str, torch.device, None] = None
                          ) -> object:
    """Carry a KWS-family parameter tree of numpy arrays (nested dicts and
    lists, as ``repro.models.kws.*_init`` returns it, mapped to numpy) across
    as the same tree of float32 tensors on ``device`` (``cuda`` unless
    named), layouts kept: HWIO/WIO convolution weights, (in, out) dense
    weights."""
    device = resolve_device(device)
    return map_tree(
        lambda x: torch.from_numpy(np.array(x, np.float32)).to(device),
        params)
