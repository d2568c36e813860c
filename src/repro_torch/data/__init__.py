"""Synthetic, deterministic graph, update-stream and molecule generators."""

from repro_torch.data.pipelines import (graph_stream, molecule_batch,
                                        random_graph_edges)

__all__ = ["graph_stream", "molecule_batch", "random_graph_edges"]
