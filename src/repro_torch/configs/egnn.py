"""egnn [arXiv:2102.09844]: n_layers=4 d_hidden=64, E(n)-equivariant.

The port's own copy of ``repro.configs.egnn``'s ``CONFIG``, ``SMOKE``
and ``SPEC``."""

import dataclasses

from repro_torch.configs.common import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=8, d_in=4)

SPEC = ArchSpec(arch_id="egnn", family="gnn", config=CONFIG, smoke=SMOKE,
                shapes=GNN_SHAPES, source="arXiv:2102.09844; paper")
