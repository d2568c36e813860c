"""Query serving: the routed, bucket-padded ``QueryEngine`` and the
versioned snapshot store.

Port of the single-device part of ``repro.serve``: the engine, the
``SnapshotStore`` and the in-process ``LocalTransport``.  The
cross-process transports, replicas, the service façade and the front
door belong to later slices of the port.
"""

from repro_torch.serve.engine import (DEFAULT_BUCKETS, QueryEngine,
                                      ServeStats, ServeStatsView,
                                      bucket_size, coalesce_pairs,
                                      split_rows)
from repro_torch.serve.publish import SnapshotStore
from repro_torch.serve.routing import KINDS, RoutePolicy
from repro_torch.serve.transport import (LocalTransport, PublisherBehindError,
                                         Snapshot, SnapshotGoneError,
                                         SnapshotTransport, TransportError)

__all__ = ["DEFAULT_BUCKETS", "KINDS", "LocalTransport",
           "PublisherBehindError", "QueryEngine", "RoutePolicy",
           "ServeStats", "ServeStatsView", "Snapshot", "SnapshotGoneError",
           "SnapshotStore", "SnapshotTransport", "TransportError",
           "bucket_size", "coalesce_pairs", "split_rows"]
