"""GNN models of the port on the segment-op message-passing substrate:

* ``graph``         -- padded ``GraphBatch`` + segment aggregations.
* ``irreps``        -- SO(3) machinery (real SH, CG, Wigner D).
* ``egnn``          -- E(n)-equivariant GNN (scalar-distance messages).
* ``pna``           -- Principal Neighbourhood Aggregation.
* ``nequip``        -- tensor-product interatomic potential (l_max=2).
* ``equiformer_v2`` -- eSCN SO(2) graph attention (l_max=6, m_max=2).
* ``sampler``       -- k-hop neighbour sampler for ``minibatch_lg``.
"""

from repro_torch.models.gnn.graph import GraphBatch, batch_spec, from_numpy

__all__ = ["GraphBatch", "batch_spec", "from_numpy"]
