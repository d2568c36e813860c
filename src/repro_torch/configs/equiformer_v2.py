"""equiformer-v2 [arXiv:2306.12059]: n_layers=12 d_hidden=128 l_max=6
m_max=2 n_heads=8, SO(2)-eSCN equivariant graph attention.

The port's own copy of ``repro.configs.equiformer_v2``'s ``CONFIG``,
``SMOKE`` and ``SPEC``."""

import dataclasses

from repro_torch.configs.common import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

CONFIG = EquiformerV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                            l_max=6, m_max=2, n_heads=8)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=8, l_max=2,
                            m_max=1, n_heads=2, n_rbf=8, d_in=4)

SPEC = ArchSpec(arch_id="equiformer-v2", family="gnn", config=CONFIG,
                smoke=SMOKE, shapes=GNN_SHAPES,
                source="arXiv:2306.12059; unverified")
