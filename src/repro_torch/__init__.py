"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

Mirrors ``repro``'s module paths.  It imports ``torch`` and never
``jax`` or ``repro``: the JAX package is the reference the tests hold
this one against.  Every entry point runs on ``cuda`` unless the caller
passes ``device="cpu"``; it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when ``cuda`` is asked for (explicitly or by default)
    and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available;"
                " pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
