"""Query serving: the routed, bucket-padded ``QueryEngine``.

Port of the single-device part of ``repro.serve``; the snapshot store,
transports, replicas, the service façade and the front door belong to
later slices of the port.
"""

from repro_torch.serve.engine import (DEFAULT_BUCKETS, QueryEngine,
                                      ServeStats, ServeStatsView,
                                      bucket_size, coalesce_pairs,
                                      split_rows)
from repro_torch.serve.routing import KINDS, RoutePolicy

__all__ = ["DEFAULT_BUCKETS", "KINDS", "QueryEngine", "RoutePolicy",
           "ServeStats", "ServeStatsView", "bucket_size", "coalesce_pairs",
           "split_rows"]
