"""Logical-axis sharding policy (DP / FSDP / TP / EP / SP): the
counterpart of ``repro.sharding.policy``, with the same rule tables.

Model code never names mesh axes.  A tensor's axes carry *logical* names
(``models/params.py::logical_axes``, ``models/api.py::
input_logical_axes``); a rule table maps each logical name to mesh axes.
Swapping the table is how the pod tuner (``core/tuner.py``) explores
layouts, as the EON Tuner swaps target-device constraints.

Divisibility is checked against the mesh: a logical axis whose dimension
does not divide the mapped mesh axes falls back to replication for that
dimension (4 KV heads on a 16-way model axis), and a mesh axis is never
assigned twice in one spec.  The arithmetic takes any ``Mesh``
(``launch/mesh.py``), a production mesh of shapes alone too.

The port runs on one card: ``constrain`` is the identity outside
``use_rules`` and on a mesh of one device, and raises on a mesh of more
(no model module calls it).  ``PartitionSpec`` is a tuple (equal, as a
tuple, to the reference's ``P`` of the same entries) and
``NamedSharding`` pairs it with its mesh; placing a tensor by it goes to
the mesh's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh, mesh_name

AxisAssignment = Union[None, str, Tuple[str, ...]]
AxisRules = Dict[str, AxisAssignment]

_state = threading.local()


class PartitionSpec(tuple):
    """A mesh axis (or a tuple of them, or None) for each tensor dim,
    trailing Nones dropped."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        """The device a tensor placed by this sharding lives on (raises on
        a mesh without devices, or of more than one)."""
        return self.mesh.device


def _current() -> Tuple[Optional[Mesh], Optional[AxisRules]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


def current_mesh_rules() -> Tuple[Optional[Mesh], Optional[AxisRules]]:
    """The mesh and rules of the enclosing ``use_rules`` (None outside)."""
    return _current()


def axis_assignment_size(mesh: Optional[Mesh],
                         assignment: AxisAssignment) -> int:
    if mesh is None or assignment is None:
        return 1
    axes = (assignment,) if isinstance(assignment, str) else assignment
    n = 1
    for a in axes:
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


@contextlib.contextmanager
def use_rules(rules: AxisRules, mesh: Mesh):
    """Activate a rule table and mesh for ``constrain`` calls underneath."""
    prev = _current()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: AxisRules, mesh: Optional[Mesh] = None,
                     shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Map logical axis names to a ``PartitionSpec``, dropping
    assignments that do not divide the dimension or name no axis of the
    mesh.  Mesh axes are never assigned twice."""
    spec, used = [], set()
    for i, name in enumerate(logical_axes):
        assignment = rules.get(name) if name is not None else None
        if assignment is None:
            spec.append(None)
            continue
        axes = (assignment,) if isinstance(assignment, str) \
            else tuple(assignment)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            spec.append(None)
            continue
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh.shape)
            if not axes:
                spec.append(None)
                continue
            if shape is not None:
                size = 1
                for a in axes:
                    size *= mesh.shape[a]
                if size == 0 or shape[i] % size != 0:
                    spec.append(None)
                    continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else tuple(axes))
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity outside ``use_rules`` and on a mesh of one device; a mesh of
    more devices raises (the port shards nothing)."""
    mesh, rules = _current()
    if mesh is None or rules is None or mesh.size == 1:
        return x
    raise NotImplementedError(
        f"constrain on mesh {mesh_name(mesh)} ({mesh.size} devices): the"
        " port runs on a mesh of one device")


def _map_axes(fn, tree, *rest):
    """``fn`` over the logical-axes tuples of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def params_pspecs(logical_tree, rules: AxisRules, mesh: Mesh,
                  shapes_tree=None):
    """Map a tree of logical-axis tuples to ``NamedSharding``s.

    ``shapes_tree`` (a matching tree of tensors, meta tensors or shapes;
    a ``ParamTree`` too) enables the divisibility fallback per leaf."""
    if shapes_tree is None:
        return _map_axes(lambda axes: NamedSharding(
            mesh, logical_to_pspec(axes, rules, mesh)), logical_tree)
    if hasattr(shapes_tree, "tree"):
        shapes_tree = shapes_tree.tree()
    return _map_axes(lambda axes, s: NamedSharding(
        mesh, logical_to_pspec(axes, rules, mesh, getattr(s, "shape", s))),
        logical_tree, shapes_tree)


# ---------------------------------------------------------------------------
# Rule tables (the tuner's sharding search space)
# ---------------------------------------------------------------------------
def make_rules(strategy: str = "tp", multi_pod: bool = False,
               decode: bool = False) -> AxisRules:
    """Build a rule table (the reference's, entry for entry).

    Strategies
    ----------
    tp        : Megatron-style TP over "model" (heads / d_ff / experts /
                vocab), DP over ("pod", "data"), FSDP weight storage over
                "data".
    cp        : context parallelism: the query sequence sharded over
                "model" (any head count), the MLP stays ff-sharded.
    tp_sp     : tp with the residual stream between blocks sharded by
                sequence (Megatron SP).
    replicated: no model-axis sharding.
    """
    batch_axes: AxisAssignment = ("pod", "data") if multi_pod else ("data",)
    fsdp: AxisAssignment = "data"

    base: AxisRules = {
        # --- parameters ---
        "p_dmodel": fsdp,          # FSDP storage dim
        "p_heads": "model",
        "p_kv_heads": "model",
        "p_ff": "model",
        "p_ff_in": fsdp,           # second dim of down-proj
        "p_vocab": "model",
        "p_experts": "model",
        "p_dinner": "model",
        "p_state": None,
        "p_conv": None,
        "layers": None,
        # --- activations ---
        "act_batch": batch_axes,
        "act_seq": None,
        "act_res_seq": None,   # residual stream between blocks (SP)
        "act_dmodel": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_kv_seq": None,
        "act_ff": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "act_expert_cap": batch_axes,   # EP: capacity dim over the DP axes
        "act_dinner": "model",
        # the KV cache's length: over "model" at prefill, over ("data",
        # "model") at decode (flash-decoding)
        "act_cache_seq": "model",
    }
    if strategy == "cp":
        base.update({
            "p_heads": None, "p_kv_heads": None,
            "act_heads": None, "act_kv_heads": None,
            "act_seq": "model",        # queries sharded over model axis
            "act_kv_seq": None,        # K/V gathered (cheap under GQA)
        })
    elif strategy == "tp_sp":
        base.update({"act_res_seq": "model"})
    elif strategy == "replicated":
        for k in list(base):
            if k != "act_batch":
                base[k] = None
    elif strategy != "tp":
        raise ValueError(f"unknown strategy {strategy!r}")

    if decode:
        # one-token decode: no sequence to shard; the cache's length is
        # sharded instead, over the data axis too, and heads replicated
        base["act_seq"] = None
        base["act_cache_seq"] = ("data", "model")
        base["act_kv_seq"] = None
        base["act_heads"] = None
        base["act_kv_heads"] = None
    return base


def input_sharding(mesh: Mesh, rules: AxisRules, logical_axes, shape
                   ) -> NamedSharding:
    return NamedSharding(mesh, logical_to_pspec(logical_axes, rules, mesh,
                                                shape))
