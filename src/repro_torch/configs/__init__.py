"""Architecture registry of the port: ``get("<arch-id>")`` -> ArchSpec.

The ported architectures: ``dspc`` (the paper's own workload), ``pna``
(the GNN of the recommendation re-rank) and ``qwen2-1.5b`` (the dense
GQA LM of the serving path).  Any other id of the reference raises
``KeyError`` until its slice is ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.common import ArchSpec, ShapeSpec
from repro_torch.configs.dspc import CONFIG, SMOKE, DSPCArchConfig

_MODULES = {
    "dspc": "repro_torch.configs.dspc",
    "pna": "repro_torch.configs.pna",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC


__all__ = ["ARCH_IDS", "ArchSpec", "CONFIG", "SMOKE", "DSPCArchConfig",
           "ShapeSpec", "get"]
