"""Elastic scaling: rebuild a smaller or larger mesh and restore the
state onto it (the counterpart of ``repro.launch.elastic``).

The runbook: detect the loss (the trainer's watchdog), take the latest
checkpoint, rebuild a mesh from the devices that survive
(``plan_rescale``, ``build_mesh``), restore onto it (``elastic_restore``:
the checkpoint holds global shapes, so any mesh whose axes divide them
takes it), rescale the data pipeline's shards.  ``plan_rescale`` is the
reference's arithmetic and takes any mesh shape, a pod's too.
``build_mesh`` makes a mesh of the devices this machine has and raises
beyond them; the port places tensors on a mesh of one device, so a
checkpoint written by a job on many devices restores onto one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.policy import AxisRules, params_pspecs


@dataclasses.dataclass
class ElasticPlan:
    old_shape: Dict[str, int]
    new_shape: Dict[str, int]
    note: str


def plan_rescale(mesh_shape: Dict[str, int], surviving_devices: int,
                 *, keep_model_axis: bool = True) -> ElasticPlan:
    """Choose a new mesh shape for the surviving device count.

    Policy: keep the "model" axis (its degree is baked into layouts and
    tile choices); shrink the data-parallel axes ("pod" first, then
    "data") to the largest power of two that fits.  The per-device
    weight shards stay the same, so a restore re-places the weights."""
    model = mesh_shape.get("model", 1)
    assert surviving_devices >= model, "fewer devices than TP degree"
    dp_budget = surviving_devices // model
    # largest power of two <= dp_budget
    dp = 1
    while dp * 2 <= dp_budget:
        dp *= 2
    new: Dict[str, int] = {}
    if "pod" in mesh_shape and dp >= mesh_shape["data"]:
        new["pod"] = dp // mesh_shape["data"]
        new["data"] = mesh_shape["data"]
    else:
        new["data"] = dp
    new["model"] = model
    return ElasticPlan(dict(mesh_shape), new,
                       note=f"rescale {mesh_shape} -> {new} "
                            f"({surviving_devices} devices survive)")


def build_mesh(shape: Dict[str, int],
               device: Union[str, torch.device, None] = None) -> Mesh:
    """A mesh of ``shape`` over this machine's devices of ``device``'s
    type (``cuda`` unless named); raises when it asks for more devices
    than there are."""
    dev = resolve_device(device)
    n = 1
    for v in shape.values():
        n *= v
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > have:
        raise RuntimeError(f"mesh {shape} needs {n} devices; this machine"
                           f" has {have} {dev.type} device(s)")
    devices = [torch.device(dev.type, i) for i in range(n)] \
        if dev.type == "cuda" else [dev]
    return Mesh(shape, devices)


def elastic_restore(ckpt: Checkpointer, tree_like, rules: AxisRules,
                    logical_tree, new_mesh: Mesh,
                    step: Optional[int] = None):
    """Restore the latest (or ``step``'s) checkpoint onto ``new_mesh``:
    returns (a nested dict of tensors on the mesh's device, extra)."""
    shardings = params_pspecs(logical_tree, rules, new_mesh,
                              shapes_tree=tree_like)
    return ckpt.restore(tree_like, step, shardings)
