"""Architecture registry of the port: ``get("<arch-id>")`` -> ArchSpec.

The ported architectures: ``dspc`` (the paper's own workload), the
reference's four GNNs (``pna``, the GNN of the recommendation re-rank,
and the equivariant ``egnn``, ``nequip`` and ``equiformer-v2``) and its
five LMs: the dense GQA ``qwen2-1.5b``, ``qwen2-7b`` and
``phi3-medium-14b``, and the MLA + MoE ``deepseek-v2-lite-16b`` and
``deepseek-v2-236b``; and the recsys ``dien``.  Every id of the
reference's registry is ported; any other raises ``KeyError``.
``ASSIGNED_ARCH_IDS`` are the ten model architectures (every id but
``dspc``), and ``all_specs()`` maps each id to its ``ArchSpec``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.common import ArchSpec, ShapeSpec
from repro_torch.configs.dspc import CONFIG, SMOKE, DSPCArchConfig

_MODULES = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "egnn": "repro_torch.configs.egnn",
    "pna": "repro_torch.configs.pna",
    "nequip": "repro_torch.configs.nequip",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "dien": "repro_torch.configs.dien",
    "dspc": "repro_torch.configs.dspc",
}

ARCH_IDS = tuple(_MODULES)
ASSIGNED_ARCH_IDS = tuple(a for a in ARCH_IDS if a != "dspc")


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC


def all_specs() -> dict:
    return {a: get(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ASSIGNED_ARCH_IDS", "ArchSpec", "CONFIG", "SMOKE",
           "DSPCArchConfig", "ShapeSpec", "all_specs", "get"]
