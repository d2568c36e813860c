"""Configurations the port runs: ``dspc`` (the paper's own workload) and
``pna`` (the GNN of the recommendation re-rank)."""

from repro_torch.configs.dspc import CONFIG, SMOKE, DSPCArchConfig

__all__ = ["CONFIG", "SMOKE", "DSPCArchConfig"]
