"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75,
aggregators=mean-max-min-std, scalers=id-amp-atten.

The port's own copy of ``repro.configs.pna``'s ``CONFIG``,
``SMOKE`` and ``SPEC``."""

import dataclasses

from repro_torch.configs.common import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn.pna import PNAConfig

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=8, d_in=4)

SPEC = ArchSpec(arch_id="pna", family="gnn", config=CONFIG, smoke=SMOKE,
                shapes=GNN_SHAPES, source="arXiv:2004.05718; paper")
