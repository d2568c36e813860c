"""repro_torch.analytics: workloads served from the dynamic SPC index.

Port of ``repro.analytics``: betweenness, shortest-cycle counting
(undirected from the index, directed from the ``core.directed`` labels)
and friend recommendation, each computed from one pinned published
snapshot (``SnapshotStore.current()``).  Entry point:
:class:`AnalyticsEngine`.
"""

from repro_torch.analytics.betweenness import (TopKBetweenness, all_pairs,
                                               betweenness, betweenness_numpy,
                                               changed_rows,
                                               dependency_scores)
from repro_torch.analytics.cycles import (
    CycleCount, cycle_through_edge_directed,
    cycle_through_edge_directed_oracle, cycle_through_vertex_directed,
    cycle_through_vertex_directed_oracle, cycles_through_edge,
    cycles_through_vertex, neighbors)
from repro_torch.analytics.engine import AnalyticsEngine, PinnedAnalytics
from repro_torch.analytics.recommend import (Recommendation,
                                             common_neighbor_ids, recommend,
                                             recommend_numpy,
                                             recommendation_features)

__all__ = [
    "AnalyticsEngine", "PinnedAnalytics",
    "TopKBetweenness", "betweenness", "betweenness_numpy",
    "dependency_scores", "changed_rows", "all_pairs",
    "CycleCount", "cycles_through_vertex", "cycles_through_edge",
    "neighbors", "cycle_through_edge_directed",
    "cycle_through_vertex_directed", "cycle_through_edge_directed_oracle",
    "cycle_through_vertex_directed_oracle",
    "Recommendation", "recommend", "recommend_numpy",
    "recommendation_features", "common_neighbor_ids",
]
