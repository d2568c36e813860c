"""Synthetic, deterministic batch, graph, update-stream and molecule
generators."""

from repro_torch.data.pipelines import (dien_batch, graph_stream, lm_batch,
                                        molecule_batch, random_graph_edges)

__all__ = ["dien_batch", "graph_stream", "lm_batch", "molecule_batch",
           "random_graph_edges"]
