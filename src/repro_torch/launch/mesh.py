"""Device meshes: named axes mapped to sizes, and the devices they hold.

The counterpart of ``repro.launch.mesh`` for a machine of one card.  A
``Mesh`` is plain data: axis names in order, their sizes, and the
devices, where it has them.  ``make_host_mesh`` is the one-device mesh
``{"data": 1, "model": 1}`` on the card (or on the CPU when the caller
asks).  ``make_production_mesh`` gives the reference's pod shapes, 16 x
16 and 2 x 16 x 16, **without devices**: the sharding rules, the
partition specs and ``launch/elastic.py::plan_rescale`` take it, as the
reference's tests take their shape-only mesh, and anything that would
place or run a tensor on it raises, saying how many devices it needs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch import resolve_device


class Mesh:
    def __init__(self, shape: Dict[str, int],
                 devices: Optional[Sequence[torch.device]] = None):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names = tuple(self.shape)
        self.devices = None if devices is None else tuple(devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} of {self.size} devices"
                             f" given {len(self.devices)}")

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def device(self) -> torch.device:
        """The device a tensor placed on this mesh lives on: the mesh's one
        device.  Raises on a mesh without devices or of more than one."""
        if self.devices is None:
            raise RuntimeError(
                f"mesh {mesh_name(self)} has no devices: placing or running"
                f" a tensor on it needs {self.size} devices")
        if self.size != 1:
            raise NotImplementedError(
                f"mesh {mesh_name(self)} spans {self.size} devices: the port"
                " places tensors on a mesh of one device")
        return self.devices[0]

    def __repr__(self) -> str:
        where = "no devices" if self.devices is None else \
            ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.shape}, {where})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (one pod, 256 chips) or 2 x 16 x 16 (two pods), shapes only.

    Axes: "pod" (data-parallel outer), "data" (data parallel and the
    weights' FSDP storage), "model" (tensor, expert and sequence
    parallel)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The one-device mesh ``{"data": 1, "model": 1}`` on ``device``
    (``cuda`` unless named)."""
    return Mesh({"data": 1, "model": 1}, [resolve_device(device)])


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
