"""nequip [arXiv:2101.03164]: n_layers=5 d_hidden=32 l_max=2 n_rbf=8
cutoff=5, E(3) tensor-product interatomic potential.

The port's own copy of ``repro.configs.nequip``'s ``CONFIG``, ``SMOKE``
and ``SPEC``."""

import dataclasses

from repro_torch.configs.common import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn.nequip import NequIPConfig

CONFIG = NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                      n_rbf=8, cutoff=5.0)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=4, l_max=1,
                            n_rbf=4, d_in=4)

SPEC = ArchSpec(arch_id="nequip", family="gnn", config=CONFIG, smoke=SMOKE,
                shapes=GNN_SHAPES, source="arXiv:2101.03164; paper")
