"""The canonical lock hierarchy (outermost first).

The port's own copy of the reference table: the names and their order
are the reference's, so a lock created here ranks exactly where the
reference's lock of the same name ranks.  Every name is created by the
port: ``frontdoor.cond`` (``serve.frontdoor``), ``service.submit_lock``,
``service.reader_lock`` and ``service.cond`` (``serve.service``),
``session.lock`` (``serve.service.Session``), ``analytics.lock``
(``analytics.betweenness``), ``replica.lock`` (``serve.replica``),
``store.lock`` (``serve.publish``), ``transport.cond``
(``serve.transport``) and the two leaf counter locks
(``update_stats.lock`` in ``core.dynamic``, ``serve_stats.lock`` in
``serve.engine``).

A nested acquisition must move strictly *down* this table; a lock name
outside it is an error.
"""

from __future__ import annotations

#: (canonical name, owner + what it guards), outermost first.
HIERARCHY = (
    ("frontdoor.cond", "front door: pending queue, admission counters"),
    ("service.submit_lock", "service ingest admission"),
    ("service.reader_lock", "service replica round-robin (reentrant)"),
    ("service.cond", "service tickets, updater failure, versions"),
    ("session.lock", "per-session last submit ticket"),
    ("analytics.lock", "maintained analytics score swap"),
    ("replica.lock", "replica puller bookkeeping"),
    ("store.lock", "snapshot store front pointer"),
    ("transport.cond", "snapshot transport state"),
    ("update_stats.lock",
     "core.dynamic.UpdateStats._lock: updater counters (leaf)"),
    ("serve_stats.lock",
     "serve.engine.ServeStats._lock: per-engine serve counters (leaf)"),
)

#: canonical name -> rank; nested acquisitions must strictly increase.
RANKS = {name: rank for rank, (name, _) in enumerate(HIERARCHY)}
