"""dien [arXiv:1809.03672]: embed_dim=18 seq_len=100 gru_dim=108
mlp=200-80 interaction=augru.  Item vocabulary sized for the
``retrieval_cand`` shape (10^6 candidates scored against the table).

The port's own copy of ``repro.configs.dien``'s ``CONFIG``, ``SMOKE``
and ``SPEC``."""

import dataclasses

from repro_torch.configs.common import RECSYS_SHAPES, ArchSpec
from repro_torch.models.dien import DIENConfig

CONFIG = DIENConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                    mlp=(200, 80), n_items=4_000_000, n_cates=10_000)
SMOKE = dataclasses.replace(CONFIG, n_items=500, n_cates=20,
                            n_profile_vocab=100, seq_len=10)

SPEC = ArchSpec(arch_id="dien", family="recsys", config=CONFIG, smoke=SMOKE,
                shapes=RECSYS_SHAPES, source="arXiv:1809.03672; unverified")
