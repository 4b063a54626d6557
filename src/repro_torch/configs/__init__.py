"""Architecture config registry: ``get(arch_id)`` returns the FULL config,
``get_smoke(arch_id)`` the reduced CPU-sized config of the same family.

Every id of ``ALIASES`` has a module here: the ten configs of the JAX
package, all ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from repro_torch.core.arch import ArchConfig

# the module names of the assigned architectures, in the JAX package's order
ARCH_IDS: List[str] = [
    "internlm2_1_8b",
    "granite_3_8b",
    "gemma3_4b",
    "llama3_2_3b",
    "seamless_m4t_large_v2",
    "dbrx_132b",
    "phi3_5_moe_42b",
    "zamba2_2_7b",
    "falcon_mamba_7b",
    "qwen2_vl_72b",
]

# canonical dashed ids (CLI --arch) -> module names
ALIASES: Dict[str, str] = {
    "internlm2-1.8b": "internlm2_1_8b",
    "granite-3-8b": "granite_3_8b",
    "gemma3-4b": "gemma3_4b",
    "llama3.2-3b": "llama3_2_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "dbrx-132b": "dbrx_132b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "zamba2-2.7b": "zamba2_2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

PORTED = ("internlm2_1_8b", "falcon_mamba_7b", "granite_3_8b", "llama3_2_3b",
          "gemma3_4b", "zamba2_2_7b", "phi3_5_moe_42b", "dbrx_132b",
          "seamless_m4t_large_v2", "qwen2_vl_72b")

# the port slice (ROADMAP.md, queue 1) that brings each module not yet in
# PORTED: none is left
_LATER: Dict[str, str] = {}


def _name(arch_id: str) -> str:
    return ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))


def comes_with(arch_id: str) -> Optional[str]:
    """The port slice that brings ``arch_id``; None once it is ported."""
    mod_name = _name(arch_id)
    if mod_name in PORTED:
        return None
    return _LATER.get(mod_name, "a later slice (ROADMAP.md, queue 1)")


def _module(arch_id: str):
    later = comes_with(arch_id)
    if later is not None:
        raise NotImplementedError(
            f"{arch_id}: not ported yet; it comes with {later}")
    return importlib.import_module(f"repro_torch.configs.{_name(arch_id)}")


def get(arch_id: str) -> ArchConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


def all_archs() -> List[str]:
    return list(ARCH_IDS)
