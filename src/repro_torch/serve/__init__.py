"""Query serving: one façade in front of the whole system.

Port of ``repro.serve``.  **Public API:**
``SPCService`` -- the config-driven façade that owns the updater
(``DynamicSPC``), the versioned ``SnapshotStore`` and its transport,
and N ``QueryEngine`` replicas behind one lifecycle.  Writes go through
``service.submit(events)`` (bounded async ingest, backpressure,
failures surfaced on the next call); reads through
``service.reader(consistency=...)`` (pinned / read-your-writes /
at_version, read-your-writes scoped to ``Session`` handles).
``FrontDoor`` coalesces many callers' single ``(s, t)`` queries into
one batch under admission control and deadlines.

The layers stay importable for composition and tests: ``QueryEngine``
(routes ``kernel`` / ``merge`` / ``table``), ``SnapshotStore``, the
transports (``LocalTransport``, ``DirTransport``, ``SocketTransport``,
``load_snapshot`` in the reference's npz layout) and ``ReplicaGroup``,
the puller end of a transport that ``SPCService(role="replica")``
wraps.  Over a device mesh (``repro_torch.launch.mesh``) the service
runs its updater edge-sharded (``mesh=``), stages snapshots replicated
over a serving mesh (``serve_mesh=``) and binds ``sharded`` policies to
it (``QueryEngine.sharded``), all from one controller process.
"""

from repro_torch.serve.engine import (DEFAULT_BUCKETS, QueryEngine,
                                      ServeStats, ServeStatsView,
                                      bucket_size, coalesce_pairs,
                                      split_rows)
from repro_torch.serve.frontdoor import (DeadlineExceeded, FrontDoor,
                                         FrontDoorError, FrontDoorSession,
                                         Overloaded)
from repro_torch.serve.publish import SnapshotStore
from repro_torch.serve.replica import ReplicaGroup
from repro_torch.serve.routing import KINDS, RoutePolicy
from repro_torch.serve.service import (CONSISTENCY_LEVELS, NO_TICKET, ROLES,
                                       ReplicaReadOnlyError, Session,
                                       SPCService, UpdaterError)
from repro_torch.serve.transport import (FETCH_RETRIES, TRANSPORTS,
                                         DirTransport, LocalTransport,
                                         PublisherBehindError, Snapshot,
                                         SnapshotGoneError,
                                         SnapshotTransport, SocketTransport,
                                         TransportError, load_snapshot,
                                         make_transport, snapshot_tree)

__all__ = ["SPCService", "Session", "NO_TICKET", "RoutePolicy", "KINDS",
           "UpdaterError", "CONSISTENCY_LEVELS", "ROLES",
           "ReplicaReadOnlyError", "ReplicaGroup",
           "FrontDoor", "FrontDoorSession", "FrontDoorError",
           "Overloaded", "DeadlineExceeded",
           "QueryEngine", "ServeStats", "ServeStatsView",
           "DEFAULT_BUCKETS", "bucket_size", "coalesce_pairs", "split_rows",
           "Snapshot", "SnapshotStore", "SnapshotGoneError",
           "load_snapshot", "snapshot_tree", "FETCH_RETRIES",
           "SnapshotTransport", "LocalTransport", "DirTransport",
           "SocketTransport", "TransportError", "PublisherBehindError",
           "TRANSPORTS", "make_transport"]
