"""The canonical lock hierarchy (outermost first).

The port's own copy of the reference table, word for word: the names,
their order and the reentrant set are the reference's, so a lock created
here ranks exactly where the reference's lock of the same name ranks.
Every name is created by the port: ``frontdoor.cond``
(``serve.frontdoor``), ``service.submit_lock``, ``service.reader_lock``
and ``service.cond`` (``serve.service``), ``session.lock``
(``serve.service.Session``), ``analytics.lock``
(``analytics.betweenness``), ``replica.lock`` (``serve.replica``),
``store.lock`` (``serve.publish``), ``transport.cond``
(``serve.transport``) and the two leaf counter locks
(``update_stats.lock`` in ``core.dynamic``, ``serve_stats.lock`` in
``serve.engine``).

A nested acquisition must move strictly *down* this table; a lock name
outside it is an error.  The static analyzer
(``repro_torch.analysis.lockorder``) and the runtime shadow checker
(``repro_torch.analysis.shadow``) both read it.
"""

from __future__ import annotations

#: (canonical name, owner + what it guards), outermost first.
HIERARCHY = (
    ("frontdoor.cond",
     "FrontDoor._cond: pending-request queue, admission counters, "
     "dispatcher wakeups"),
    ("service.submit_lock",
     "SPCService._submit_lock: ingest admission; ticket order == "
     "queue order"),
    ("service.reader_lock",
     "SPCService._reader_lock: replica round-robin + dedicated-engine "
     "cache + lazy default-reader build (reentrant)"),
    ("service.cond",
     "SPCService._cond: accepted/applied tickets, updater failure, "
     "ticket->version map"),
    ("session.lock",
     "Session._lock: per-session last submit ticket"),
    ("analytics.lock",
     "analytics.TopKBetweenness._lock: maintained score/snapshot swap "
     "(a leaf in practice: scoring dispatches run before acquisition, "
     "never under it)"),
    ("replica.lock",
     "ReplicaGroup._lock: puller counters, last error, observed "
     "remote version (never held across store.publish)"),
    ("store.lock",
     "SnapshotStore._lock: front snapshot pointer + publish count"),
    ("transport.cond",
     "transport._cond: LocalTransport published slot + notify, socket "
     "transport subscriber list"),
    ("update_stats.lock",
     "core.dynamic.UpdateStats._lock: updater counters (leaf)"),
    ("serve_stats.lock",
     "serve.engine.ServeStats._lock: per-engine serve counters (leaf)"),
)

#: canonical name -> rank; nested acquisitions must strictly increase.
RANKS = {name: rank for rank, (name, _) in enumerate(HIERARCHY)}

#: Locks a thread may legally re-acquire while holding them
#: (``threading.RLock``, and ``threading.Condition`` whose default
#: backing lock is an RLock).
REENTRANT = frozenset({
    "frontdoor.cond",
    "service.reader_lock",
    "service.cond",
    "transport.cond",
})


def describe(name: str) -> str:
    for n, what in HIERARCHY:
        if n == name:
            return what
    return "<undeclared>"
