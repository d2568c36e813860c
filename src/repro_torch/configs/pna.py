"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75,
aggregators=mean-max-min-std, scalers=id-amp-atten.

The port's own copy of ``repro.configs.pna``'s ``CONFIG`` and
``SMOKE``."""

import dataclasses

from repro_torch.models.gnn.pna import PNAConfig

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=8, d_in=4)
