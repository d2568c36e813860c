"""Config registry plumbing (port of part of ``repro.configs.common``):
``ArchSpec``, ``ShapeSpec`` and the shape tables of the ported families,
values verbatim.

Every ported architecture has one module defining ``CONFIG`` (the
published hyperparameters), ``SMOKE`` (a reduced same-family config for
CPU tests) and ``SPEC``; ``repro_torch.configs.get(arch_id)`` returns
the ``ArchSpec``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | full_graph | sampled |
                       # molecule | recsys_train | recsys_serve | retrieval |
                       # dspc_*
    dims: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys | dspc
    config: Any
    smoke: Any
    shapes: Dict[str, ShapeSpec]
    source: str = ""   # citation string


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "full_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "sampled",
        dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
             fanout=(15, 10), d_feat=602, n_classes=41)),
    "ogb_products": ShapeSpec(
        "ogb_products", "full_graph",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    "molecule": ShapeSpec(
        "molecule", "molecule",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train",
                             dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve",
                            dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}

# The paper's own workload: a power-law graph at roofline-relevant size.
DSPC_SHAPES = {
    "build": ShapeSpec("build", "dspc_build",
                       dict(n=65536, m=524288, l_cap=64)),
    "inc_update": ShapeSpec("inc_update", "dspc_inc",
                            dict(n=65536, m=524288, l_cap=64)),
    "dec_update": ShapeSpec("dec_update", "dspc_dec",
                            dict(n=65536, m=524288, l_cap=64)),
    "query_batch": ShapeSpec("query_batch", "dspc_query",
                             dict(n=65536, m=524288, l_cap=64,
                                  batch=1_048_576)),
}
