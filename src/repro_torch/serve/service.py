"""SPCService: the one config-driven façade over the whole DSPC system.

Port of ``repro.serve.service`` (``src/repro/serve/service.py``), the
supported way to consume the system: one object owns the updater
(``DynamicSPC``), the snapshot store and its transport, the serving
engines and, on a replica, the puller group, behind one lifecycle.

* **One lifecycle.**  ``start()`` launches the background updater
  thread, ``drain()`` flushes the ingest queue, ``close()`` stops the
  thread and settles durability; ``with SPCService(...) as svc:`` does
  start/close automatically.

* **Async ingest with backpressure.**  ``submit(events)`` validates
  host-side and enqueues onto a *bounded* queue; the updater thread
  drains it through ``DynamicSPC.apply_events`` and publishes each
  committed chunk.  A full queue blocks the submitter; a timeout raises
  ``queue.Full``.  If the updater thread dies, the failure surfaces as
  ``UpdaterError`` on the next service call.

* **Explicit consistency.**  ``reader()`` returns a serving closure
  with a declared consistency level: ``pinned`` (the current published
  snapshot, pinned for the whole batch), ``read_your_writes`` (waits
  until the bound :class:`Session`'s last ticket is published) or
  ``at_version=k`` (waits until version >= k is published).

* **Routing policies.**  Routes are ``RoutePolicy`` values (auto /
  merge / table / kernel); the reference's ``pallas`` names the
  ``kernel`` route.  The reference keys its dedicated engines by the
  Pallas knobs ``(block_b, interpret)`` (``service.py:652-668``); the
  CUDA kernel takes no knobs, so the port keys them by policy: a reader
  whose policy differs from the service's gets an engine of its own.

* **Explicit roles.**  ``role="updater"`` owns the ``DynamicSPC`` and publishes
  every committed version through a ``SnapshotTransport``
  (``transport="local"|"dir"|"socket"`` + ``publish_dir=``);
  ``role="replica"`` owns none and serves what a
  ``ReplicaGroup`` pulls from the medium; ``submit`` there raises
  :class:`ReplicaReadOnlyError`.

* **The card.**  Every entry point takes ``device=`` (default
  ``"cuda"``; a prebuilt ``spc=`` brings its own).  The updater thread,
  the readers and the front door's dispatchers all launch on the
  current stream of that device, which in every thread is its default
  stream: a reader never reads a snapshot's rows on another stream than
  the one that wrote them, so the caching allocator cannot hand a
  pinned snapshot's memory to the updater.

* **Meshes.**  ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``) runs the
  updater edge-sharded over its ``edge_axis``; ``serve_mesh=`` stages
  every published snapshot replicated over the serving mesh, and
  ``sharded`` policies bind to it, splitting each batch over
  ``batch_axes``.  One controller (this process) drives every device of
  both meshes, so the threads above keep their contracts unchanged.

Thread contract: any number of submitter and reader threads, one
internal updater thread (or, on replicas, one puller thread per source
transport).  Tickets are handed out in queue order, so ``applied``
advances monotonically and read-your-writes waits are well-ordered.
"""

from __future__ import annotations

import logging
import queue as queue_lib
import threading
import time
from typing import Iterable, Sequence, Tuple

from repro_torch.analysis.shadow import (make_condition, make_lock,
                                         make_rlock)
from repro_torch.core.dynamic import DEFAULT_BATCH, DynamicSPC
from repro_torch.core.order import identity_ordering
from repro_torch.serve.engine import DEFAULT_BUCKETS, QueryEngine
from repro_torch.serve.publish import SnapshotStore
from repro_torch.serve.replica import ReplicaGroup
from repro_torch.serve.routing import RoutePolicy
from repro_torch.serve.transport import make_transport

_log = logging.getLogger(__name__)

#: Declared read-consistency levels (see module doc).
CONSISTENCY_LEVELS = ("pinned", "read_your_writes")

#: Declared service roles (see module doc).
ROLES = ("updater", "replica")

#: The "nothing to wait for" ticket sentinel.  ``submit([])`` returns it
#: (real tickets start at 1), a fresh :class:`Session` starts on it, and
#: every read-your-writes wait keyed on it returns immediately.
NO_TICKET = 0


class UpdaterError(RuntimeError):
    """The background updater thread died; every subsequent service
    call raises this with the original exception chained (__cause__)."""


class ReplicaReadOnlyError(RuntimeError):
    """``submit`` on a ``role="replica"`` service: replicas serve
    pulled snapshots and never ingest -- route writes to the updater
    host (whose published versions this replica will pull)."""


class Session:
    """Per-caller write-ticket scope: the read-your-writes unit
    (``src/repro/serve/service.py:135``).

    A session records the last ticket accepted for *its own* submits
    (``session.submit(events)`` == ``service.submit(events,
    session=session)``); a reader bound to it waits for that ticket
    only, so two callers holding two sessions never wait on each
    other's writes.  Thread-safe (``last_ticket`` advances
    monotonically).
    """

    def __init__(self, service: "SPCService") -> None:
        self._service = service
        self._lock = make_lock("session.lock")
        self._last = NO_TICKET

    @property
    def last_ticket(self) -> int:
        """Last ticket this session submitted (``NO_TICKET`` if none)."""
        with self._lock:
            return self._last

    def _record(self, ticket: int) -> None:
        with self._lock:
            if ticket > self._last:
                self._last = ticket

    def submit(self, events, *, timeout: float | None = None) -> int:
        """``service.submit`` credited to this session (see there)."""
        return self._service.submit(events, timeout=timeout, session=self)

    def reader(self, consistency: str = "read_your_writes", **kwargs):
        """A reader bound to this session (read-your-writes default)."""
        return self._service.reader(consistency, session=self, **kwargs)

    def wait_applied(self, timeout: float | None = None) -> None:
        """Block until this session's last submit is applied+published."""
        self._service.wait_for_ticket(self.last_ticket, timeout)


class SPCService:
    """Façade over updater + snapshot store + serving engines
    (``src/repro/serve/service.py:176``).

    ``TICKET_HISTORY`` bounds the ticket -> version map consulted by
    :meth:`ticket_version`: entries older than the newest applied
    ticket minus the window are pruned.

    Build fresh (``SPCService(n, edges, ...)``), around a prebuilt
    ``DynamicSPC`` (``spc=``), from a config (:meth:`from_config`), or around
    restored state (:meth:`from_state_dict` / :meth:`from_checkpoint`).

    Parameters beyond the ``DynamicSPC`` build args:

    ``serve_mesh`` / ``batch_axes``
        Serving-replica mesh: snapshots are staged replicated over it
        and ``sharded`` route policies bind to it.  Independent of the
        updater's ``mesh`` / ``edge_axis`` (edge-sharded updates).
    ``route``
        Default ``RoutePolicy`` (or route string) for readers.
    ``replicas``
        Number of ``QueryEngine`` replicas readers are assigned to
        (round-robin): a stats / fan-out knob, not a correctness one.
    ``queue_size``
        Bound of the ingest queue (backpressure point).
    ``update_batch``
        Events per ``apply_events`` chunk.
    ``wait_timeout``
        Default bound (seconds) on every blocking wait (drain,
        read-your-writes, at_version); ``TimeoutError`` past it.
    ``role`` / ``transport`` / ``publish_dir`` / ``poll_interval_s``
        The fleet knobs (module doc).  A replica needs no graph at all:
        it pulls every ``poll_interval_s`` and serves the last verified
        version.
    ``keep_published``
        Retention window of the publication directory (always includes
        the step ``LATEST`` names).
    ``device``
        Where a fresh updater builds, or a replica stages its pulls
        (default ``"cuda"``).
    """

    #: Retention window of the ticket -> version map (see class doc).
    TICKET_HISTORY = 1024

    def __init__(self, n: int | None = None,
                 edges: Sequence[Tuple[int, int]] = (), *,
                 spc: DynamicSPC | None = None,
                 l_cap: int | None = 32, cap_e: int | None = None,
                 mesh=None, edge_axis: str = "model",
                 construct_batch: int | None = None,
                 vertex_order: str = "id",
                 serve_mesh=None, batch_axes: Tuple[str, ...] = ("data",),
                 route: RoutePolicy | str | None = None,
                 replicas: int = 1, queue_size: int = 8,
                 update_batch: int = DEFAULT_BATCH,
                 buckets=DEFAULT_BUCKETS,
                 role: str = "updater",
                 transport=None, publish_dir: str | None = None,
                 poll_interval_s: float = 0.05,
                 keep_published: int = 3,
                 checkpoint_dir: str | None = None,
                 async_checkpoint: bool = False,
                 wait_timeout: float = 60.0, device="cuda") -> None:
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; want one of {ROLES}")
        if role == "replica":
            if spc is not None or n is not None or edges:
                raise ValueError(
                    "role='replica' owns no updater: drop n/edges/spc= "
                    "and point transport=/publish_dir= at the updater's "
                    "publication medium")
            if checkpoint_dir is not None:
                raise ValueError(
                    "role='replica' reads through transport=/"
                    "publish_dir=, not the legacy checkpoint_dir= shim")
        elif spc is None:
            if n is None:
                raise ValueError("pass n (+ edges) or a prebuilt spc=")
            spc = DynamicSPC(n, edges, l_cap, cap_e, mesh=mesh,
                             edge_axis=edge_axis, device=device,
                             construct_batch=construct_batch,
                             vertex_order=vertex_order)
        if not isinstance(replicas, int) or replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas!r}")
        if not isinstance(queue_size, int) or queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size!r}")
        if update_batch is not None and update_batch < 1:
            raise ValueError(
                f"update_batch must be >= 1 (or None for per-event "
                f"replay), got {update_batch!r}")
        self._serve_mesh = serve_mesh
        self._batch_axes = tuple(batch_axes)
        self._policy = self._coerce_route(route)
        if self._policy.needs_mesh and serve_mesh is None:
            raise ValueError(
                f"route policy {self._policy} needs a serving mesh; "
                f"pass serve_mesh=")
        self.role = role
        self._spc = spc  # None on replicas: no updater, no ingest
        self._group: ReplicaGroup | None = None
        if role == "replica":
            spec = transport if transport is not None else \
                ("dir" if publish_dir is not None else None)
            if spec is None:
                raise ValueError(
                    "role='replica' needs a publication medium: pass "
                    "transport= (a spec or a built SnapshotTransport) "
                    "and/or publish_dir=")
            tr = make_transport(spec, publish_dir=publish_dir,
                                keep=keep_published, device=device)
            self._group = ReplicaGroup(tr, poll_interval_s=poll_interval_s,
                                       mesh=serve_mesh, device=device)
            self._store = self._group.store
        else:
            effective_dir = publish_dir
            if checkpoint_dir is not None:
                if publish_dir is not None or transport is not None:
                    raise ValueError(
                        "checkpoint_dir= is the legacy spelling of "
                        "transport='dir' + publish_dir=; pass one or "
                        "the other, not both")
                effective_dir = checkpoint_dir
            spec = transport if transport is not None else \
                ("dir" if effective_dir is not None else "local")
            tr = make_transport(spec, publish_dir=effective_dir,
                                keep=keep_published,
                                async_save=async_checkpoint,
                                device=spc.device)
            self._store = spc.attach_store(mesh=serve_mesh, transport=tr)
        self._buckets = tuple(buckets)
        self._engines = [QueryEngine(route=self._policy,
                                     buckets=self._buckets)
                         for _ in range(replicas)]
        self._rr = 0                      # round-robin reader assignment
        # guards _rr + _dedicated + the lazy _default_reader build; an
        # RLock because building the default reader re-enters through
        # reader() -> _engine_for()
        self._reader_lock = make_rlock("service.reader_lock")
        self._dedicated: dict = {}        # RoutePolicy -> engine
        self.update_batch = update_batch
        self.wait_timeout = float(wait_timeout)
        # -- ingest machinery -------------------------------------------
        self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=queue_size)
        self._submit_lock = make_lock("service.submit_lock")
        self._cond = make_condition("service.cond")  # guards the below
        self._accepted = 0                     # last ticket handed out
        self._applied = 0                      # last ticket fully published
        self._ticket_versions: dict = {}       # ticket -> covering version
        self._failure: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._closed = False
        self._default_reader = None
        #: ticket scope for direct ``service.submit`` calls; explicit
        #: per-caller scopes come from :meth:`session`
        self._default_session = Session(self)

    def _coerce_route(self, route) -> RoutePolicy:
        """Coerce to a ``RoutePolicy``; the bare string ``"sharded"``
        picks up the service's ``batch_axes`` (an explicit policy keeps
        its own)."""
        if route == "sharded":
            return RoutePolicy.sharded(self._batch_axes)
        return RoutePolicy.coerce(route)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SPCService":
        """Launch the background machinery (idempotent): the updater
        thread, or -- on a replica -- the puller threads (blocking,
        bounded by ``wait_timeout``, until the first snapshot is
        pulled)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self._group is not None:
            self._group.start(timeout=self.wait_timeout)
            return self
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="spc-updater", daemon=True)
            self._thread.start()
        return self

    def __enter__(self) -> "SPCService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            # the body already failed: stop without drain so a full
            # queue, a dead updater or a stuck join can't mask the
            # body's exception (a stuck updater is logged, not raised)
            self._shutdown(strict=False)
        return False

    def drain(self, timeout: float | None = None) -> None:
        """Block until every accepted submit is applied AND published
        (then settle any in-flight async checkpoint).  Raises
        ``UpdaterError`` if the updater died mid-queue, ``TimeoutError``
        past ``timeout`` (default: the service's ``wait_timeout``).  On
        a replica, catch the local store up to every source's currently
        committed version instead."""
        if self._group is not None:
            self._group.catch_up(self.wait_timeout if timeout is None
                                 else timeout)
            return
        self._check_failure()
        with self._cond:
            if self._applied < self._accepted and not self._running():
                raise RuntimeError(
                    "service not started: call start() (or use the "
                    "context manager) before drain()")
        self._wait(lambda: self._applied >= self._accepted, timeout,
                   what="drain of pending ingest")
        self._store.wait()

    def close(self, timeout: float | None = None) -> None:
        """Drain, stop the updater thread, settle durability.  Safe to
        call twice.  Surfaces a pending updater failure."""
        if self._closed:
            self._check_failure()
            return
        if self._group is not None:
            # replica: no ingest to drain -- stop the pullers; the store
            # keeps serving the last pull
            self._closed = True
            self._group.close()
            return
        if not self._failed() and self._thread is None and self.pending:
            # accepted submits on a never-started service would be
            # silently discarded; refuse (the service stays open)
            raise RuntimeError(
                "service not started with submits pending: call "
                "start() before close() so they apply")
        try:
            if self._thread is not None and not self._failed():
                self.drain(timeout)
        finally:
            self._shutdown()
        self._check_failure()

    def _shutdown(self, *, strict: bool = True) -> None:
        """Stop the updater thread and settle durability.  A join that
        times out means the thread is still applying: logged and (when
        ``strict``) raised instead of silently marking the service
        closed."""
        self._closed = True
        if self._group is not None:
            self._group.close()
            return
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.wait_timeout)
            if thread.is_alive():
                msg = (f"updater thread did not stop within "
                       f"{self.wait_timeout:.1f}s of shutdown; it is "
                       f"still applying a submitted chunk -- the "
                       f"service is closed to new work but the thread "
                       f"may still mutate the index")
                _log.warning(msg)
                if strict:
                    raise TimeoutError(msg)
        self._store.wait()

    # -- ingest (write path) -------------------------------------------------
    def submit(self, events: Iterable[Tuple[str, int, int]], *,
               timeout: float | None = None,
               session: Session | None = None) -> int:
        """Accept a chunk of ('+'|'-', a, b) events for async apply
        (``src/repro/serve/service.py:448``).

        Returns a monotonically increasing *ticket* credited to
        ``session`` (default: the service's default session); an empty
        chunk returns ``NO_TICKET``.  Op tags and endpoint types are
        validated here; presence / absence at apply time, where an
        invalid stream kills the updater and surfaces as
        ``UpdaterError`` on the next call.  A full queue **blocks**;
        ``timeout=`` bounds the whole wait and raises ``queue.Full``;
        with no timeout, a full queue on a not-yet-started service
        raises ``RuntimeError`` instead of deadlocking.
        """
        if self._spc is None:
            raise ReplicaReadOnlyError(
                "this service is role='replica': it serves pulled "
                "snapshots and never ingests -- submit to the updater "
                "host (whose published versions this replica pulls)")
        self._check_failure()
        if self._closed:
            raise RuntimeError("service is closed")
        events = self._spc._normalize_events(events)
        if not events:
            return NO_TICKET  # nothing to apply, nothing to wait for
        # the deadline covers the WHOLE wait, the admission lock too
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        if deadline is None:
            self._submit_lock.acquire()
        elif not self._submit_lock.acquire(
                timeout=max(0.0, deadline - time.monotonic())):
            raise queue_lib.Full(
                "ingest admission lock held past the submit timeout")
        try:
            with self._cond:
                ticket = self._accepted + 1
            # failure-aware blocking put: a submitter parked on a full
            # queue wakes and raises if the updater dies mid-wait
            while True:
                self._check_failure()
                try:
                    self._queue.put((ticket, events), timeout=0.05)
                    break
                except queue_lib.Full:
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        raise
                    if timeout is None and not self._running():
                        self._check_failure()
                        raise RuntimeError(
                            "ingest queue is full and the updater "
                            "thread is not running; call start() or "
                            "submit with a timeout") from None
            with self._cond:
                self._accepted = ticket
        finally:
            self._submit_lock.release()
        (session or self._default_session)._record(ticket)
        return ticket

    @property
    def pending(self) -> int:
        """Accepted-but-not-yet-published tickets (clamped at 0)."""
        with self._cond:
            return max(0, self._accepted - self._applied)

    @property
    def accepted(self) -> int:
        """Last ticket handed out by :meth:`submit`."""
        with self._cond:
            return self._accepted

    @property
    def applied(self) -> int:
        """Last ticket whose events are applied and published."""
        with self._cond:
            return self._applied

    def ticket_version(self, ticket: int) -> int | None:
        """Published version covering ``ticket`` (None until applied,
        for ``NO_TICKET``, and once the ticket ages out of
        ``TICKET_HISTORY``)."""
        with self._cond:
            return self._ticket_versions.get(int(ticket))

    def session(self) -> Session:
        """A fresh per-caller write-ticket scope (see :class:`Session`)."""
        return Session(self)

    def wait_for_ticket(self, ticket: int,
                        timeout: float | None = None) -> None:
        """Block until submit ``ticket`` is applied AND published;
        ``NO_TICKET`` returns at once.  Raises ``UpdaterError`` if the
        updater died, ``TimeoutError`` past ``timeout``."""
        self._check_failure()
        ticket = int(ticket)
        if ticket <= NO_TICKET:
            return
        self._wait(lambda: self._applied >= ticket, timeout,
                   what=f"apply of submit ticket {ticket}")

    def raise_if_failed(self) -> None:
        """Raise ``UpdaterError`` (original exception chained) if the
        background updater thread died, else return."""
        self._check_failure()

    @property
    def version(self) -> int | None:
        """Version of the currently published snapshot."""
        return self._store.version

    def _run(self) -> None:
        """Updater thread: FIFO-drain the ingest queue, apply each
        submission chunked, publish, then mark its ticket applied.  It
        launches on the default stream of the index's device, as every
        reader does."""
        while True:
            try:
                ticket, events = self._queue.get(timeout=0.05)
            except queue_lib.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._spc.apply_events(events,
                                       batch_size=self.update_batch)
            except BaseException as e:
                with self._cond:
                    self._failure = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._applied = ticket
                self._ticket_versions[ticket] = self._spc.version
                # tickets apply in order: one O(1) pop keeps the map
                # bounded
                self._ticket_versions.pop(
                    ticket - self.TICKET_HISTORY, None)
                self._cond.notify_all()

    def _running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _failed(self) -> bool:
        with self._cond:
            return self._failure is not None

    def _check_failure(self) -> None:
        with self._cond:
            f = self._failure
        if f is not None:
            raise UpdaterError(
                f"updater thread died on a submitted chunk: {f!r}; "
                f"the service no longer ingests (reads still serve the "
                f"last published snapshot)") from f

    def _wait(self, done, timeout: float | None, *, what: str) -> None:
        """Wait on the service condition until ``done()``: bounded,
        failure-aware, and robust to publishes that advance without a
        notify."""
        timeout = self.wait_timeout if timeout is None else float(timeout)
        deadline = time.monotonic() + timeout
        with self._cond:
            while not done():
                self._check_failure()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{what} not satisfied within {timeout:.1f}s "
                        f"(applied={self._applied}, "
                        f"accepted={self._accepted}, "
                        f"version={self._store.version})")
                self._cond.wait(min(remaining, 0.05))

    # -- read path -----------------------------------------------------------
    def _engine_for(self, policy: RoutePolicy) -> QueryEngine:
        """Round-robin over the shared replicas; a policy other than the
        service's gets a dedicated engine, cached per policy so repeated
        readers never grow the list (the reference keys them by its
        Pallas knobs)."""
        with self._reader_lock:
            if policy == self._policy:
                eng = self._engines[self._rr % len(self._engines)]
                self._rr += 1
                return eng
            eng = self._dedicated.get(policy)
            if eng is None:
                # NOT added to _engines: the round-robin pool stays
                # default-policy replicas only (stats() lists both)
                eng = QueryEngine(route=policy, buckets=self._buckets)
                self._dedicated[policy] = eng
            return eng

    def reader(self, consistency: str = "pinned", *,
               at_version: int | None = None,
               route: RoutePolicy | str | None = None,
               timeout: float | None = None,
               session: Session | None = None):
        """Build ``serve(s, t) -> (dist int32[B], cnt int64[B])`` with a
        declared consistency level (``src/repro/serve/service.py:670``).

        Every batch pins exactly one published snapshot for its whole
        duration; the consistency level decides *which* versions are
        acceptable to pin.  Read-your-writes waits for the bound
        ``session=``'s last ticket (default: the service's default
        session).  ``route=`` overrides the service's default policy; a
        ``sharded`` policy binds the service's ``serve_mesh`` replicas.
        After each call ``serve.last_version`` holds the version that
        batch pinned.
        """
        if consistency not in CONSISTENCY_LEVELS:
            raise ValueError(
                f"unknown consistency {consistency!r}; want one of "
                f"{CONSISTENCY_LEVELS} (or at_version=k)")
        if at_version is not None and consistency != "pinned":
            raise ValueError(
                "at_version= is its own consistency mode; combine it "
                "with the default consistency='pinned' only")
        sess = self._default_session if session is None else session
        policy = (self._policy if route is None
                  else self._coerce_route(route))
        engine = self._engine_for(policy)
        sharded = None
        if policy.needs_mesh:
            if self._serve_mesh is None:
                raise ValueError(
                    f"route policy {policy} needs a serving mesh; build "
                    f"the service with serve_mesh=")
            missing = [a for a in policy.batch_axes
                       if a not in self._serve_mesh.shape]
            if missing:
                raise ValueError(
                    f"batch axes {missing} not on the serving mesh "
                    f"(axes: {tuple(self._serve_mesh.shape)})")
            sharded = engine.sharded(self._serve_mesh, policy.batch_axes)
        engine_route = policy.engine_route

        # replicas serve id-ordered snapshots: the order leaf does not
        # travel in the published payload, so a fleet updater must be
        # built with vertex_order="id" (identity translate == no-op)
        order = (identity_ordering(0) if self._spc is None
                 else self._spc.order)

        def serve(s, t):
            self._check_failure()
            if not order.identity:
                s = order.to_internal(s)
                t = order.to_internal(t)
            if at_version is not None:
                # version 0 (the seed snapshot) is a real published
                # version -- None-check, don't falsy-check
                self._wait(
                    lambda: (-1 if self._store.version is None
                             else self._store.version) >= at_version,
                    timeout, what=f"publish of version {at_version}")
            elif consistency == "read_your_writes":
                self.wait_for_ticket(sess.last_ticket, timeout)
            snap = self._store.current()   # pinned for the whole batch
            if sharded is not None:
                # the policy's route, not the engine's default: a shared
                # replica may default to a route the sharded path refuses
                d, c = sharded(snap.index, s, t, route=engine_route)
            else:
                d, c = engine.query_batch(snap.index, s, t,
                                          route=engine_route)
            b = int(d.shape[0])
            if b:
                engine.stats.count_version(snap.version, b)
            serve.last_version = snap.version
            return d, c

        serve.last_version = None
        serve.engine = engine
        serve.policy = policy
        serve.session = sess
        return serve

    def query_batch(self, s, t) -> Tuple:
        """Pinned read through a lazily built default reader.  The
        build and the read of ``_default_reader`` take
        ``service.reader_lock`` (the reference reads it lock-free)."""
        with self._reader_lock:
            if self._default_reader is None:
                self._default_reader = self.reader()
            reader = self._default_reader
        return reader(s, t)

    def query_pair(self, s: int, t: int) -> Tuple[int, int]:
        d, c = self.query_batch([s], [t])
        return int(d[0]), int(c[0])

    def frontdoor(self, **knobs) -> "object":
        """Build a coalescing :class:`repro_torch.serve.frontdoor.FrontDoor`
        over this service; knobs pass through to its constructor."""
        from repro_torch.serve.frontdoor import FrontDoor
        return FrontDoor(self, **knobs)

    def analytics(self, **knobs) -> "object":
        """Build a :class:`repro_torch.analytics.AnalyticsEngine` over
        this service's published snapshots (any role); knobs pass
        through to the engine constructor."""
        from repro_torch.analytics import AnalyticsEngine
        return AnalyticsEngine(self, **knobs)

    # -- introspection / state ----------------------------------------------
    @property
    def n(self) -> int:
        """Vertex count of the served graph: from the ``DynamicSPC`` on an
        updater, from the served snapshot on a replica."""
        if self._spc is not None:
            return self._spc.n
        return self._store.current().index.n

    @property
    def spc(self) -> DynamicSPC:
        """The owned ``DynamicSPC``; raises on a replica."""
        if self._spc is None:
            raise ReplicaReadOnlyError(
                "role='replica' owns no DynamicSPC; the updater "
                "host holds the mutable state")
        return self._spc

    @property
    def replica_group(self) -> ReplicaGroup | None:
        """The puller group feeding this service's store (None on
        updaters)."""
        return self._group

    @property
    def store(self) -> SnapshotStore:
        """The owned snapshot store (read-only interop point)."""
        return self._store

    def stats(self) -> dict:
        """One frozen, thread-safe view of the whole service: update
        counters, per-replica serve counters (shared replicas first,
        then the dedicated engines), publish / queue state."""
        with self._reader_lock:
            engines = list(self._engines) + list(self._dedicated.values())
        serve = [e.stats.snapshot() for e in engines]
        with self._cond:
            queue_state = {
                "accepted": self._accepted, "applied": self._applied,
                "pending": max(0, self._accepted - self._applied),
                "queued_chunks": self._queue.qsize(),
            }
        return {
            "role": self.role,
            "update": (None if self._spc is None
                       else self._spc.stats.snapshot()),
            "serve": serve,
            "queries": sum(v.queries for v in serve),
            "version": self._store.version,
            "publishes": self._store.publishes,
            "ingest": queue_state,
            "replica": (None if self._group is None
                        else self._group.stats()),
        }

    def state_dict(self) -> dict:
        if self._spc is None:
            raise ReplicaReadOnlyError(
                "role='replica' holds no updater state to export; "
                "checkpoint on the updater host (whose DirTransport "
                "already makes every published version durable)")
        return self._spc.state_dict()

    @classmethod
    def from_state_dict(cls, n: int, state: dict, *, mesh=None,
                        edge_axis: str = "model", device="cuda",
                        **service_kwargs) -> "SPCService":
        return cls(spc=DynamicSPC.from_state_dict(
            n, state, mesh=mesh, edge_axis=edge_axis, device=device),
            **service_kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, n: int, step: int | None = None,
                        *, mesh=None, edge_axis: str = "model",
                        device="cuda", **service_kwargs) -> "SPCService":
        """Restore the ``DynamicSPC`` from a checkpoint of a ``state_dict()``
        written by either package, onto ``device`` (edge-sharded over
        ``mesh`` when given)."""
        return cls(spc=DynamicSPC.from_checkpoint(
            path, n, step, mesh=mesh, edge_axis=edge_axis, device=device),
            **service_kwargs)

    @classmethod
    def from_config(cls, config=None, *, mesh=None, serve_mesh=None,
                    seed: int = 0, edges=None, device="cuda",
                    **overrides) -> "SPCService":
        """Build the whole serving stack from a ``configs/dspc.py``
        shape (``CONFIG`` or ``SMOKE``; ``src/repro/serve/service.py:886``).

        The graph is the config's synthetic power-law graph
        (``repro_torch.data.random_graph_edges(n, m, seed)``) unless
        ``edges=`` overrides it; ``l_cap`` / ``update_batch`` /
        ``queue_size`` / ``replicas`` / ``route`` come from the config
        (keyword ``overrides`` win).  ``mesh=`` runs the updater
        edge-sharded; ``serve_mesh=`` places snapshots for sharded
        serving replicas.
        """
        if config is None:
            from repro_torch.configs.dspc import CONFIG as config
        kwargs = dict(
            replicas=getattr(config, "replicas", 1),
            route=getattr(config, "route", None),
            role=getattr(config, "role", "updater"),
            transport=getattr(config, "transport", None),
            publish_dir=getattr(config, "publish_dir", None),
            poll_interval_s=getattr(config, "poll_interval_s", 0.05),
        )
        kwargs.update(overrides)
        if kwargs["role"] == "replica":
            # a replica builds no graph and no updater: it only pulls
            return cls(serve_mesh=serve_mesh, device=device, **kwargs)
        if edges is None:
            from repro_torch.data import random_graph_edges
            edges = random_graph_edges(config.n, config.m, seed=seed)
        kwargs.update(dict(
            l_cap=config.l_cap,
            update_batch=getattr(config, "update_batch", DEFAULT_BATCH),
            queue_size=getattr(config, "queue_size", 8),
            construct_batch=getattr(config, "construct_batch", None),
            vertex_order=getattr(config, "vertex_order", "id"),
        ), **{k: v for k, v in overrides.items() if k in (
            "l_cap", "update_batch", "queue_size", "construct_batch",
            "vertex_order")})
        return cls(config.n, edges, mesh=mesh, serve_mesh=serve_mesh,
                   device=device, **kwargs)
