"""Synthetic, deterministic graph and update-stream generators."""

from repro_torch.data.pipelines import graph_stream, random_graph_edges

__all__ = ["graph_stream", "random_graph_edges"]
