"""GNN models of the port on the segment-op message-passing substrate:
``graph`` (padded ``GraphBatch`` and segment aggregations) and ``pna``."""

from repro_torch.models.gnn.graph import GraphBatch, from_numpy

__all__ = ["GraphBatch", "from_numpy"]
