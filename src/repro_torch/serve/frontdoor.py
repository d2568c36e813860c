"""Front door: server-side request coalescing + admission control.

Port of ``repro.serve.frontdoor`` (``src/repro/serve/frontdoor.py``).
Many concurrent callers each hold a :class:`FrontDoorSession` and
submit single ``(s, t)`` queries (or small lists); dispatcher threads
coalesce whatever is pending into ONE batch and answer it through the
service's pinned-snapshot read path -- on the card, one launch of the
``spc_query`` kernel for the whole batch -- then scatter per-request
results back to the parked callers:

* **Coalescing.**  Requests queue in FIFO order; each dispatcher claims
  up to ``max_batch`` pairs of *ready* requests (deadline not expired,
  read-your-writes ticket already applied) and evaluates them as one
  engine batch.

* **Admission control.**  The pending queue is bounded by
  ``max_live_batches * max_batch`` pairs; a request past the bound is
  rejected at once with a typed :class:`Overloaded`.

* **Deadlines.**  Every request carries a deadline (default
  ``deadline_s``).  Expired requests are removed from the coalesced
  batch before dispatch and failed with :class:`DeadlineExceeded`; a
  caller whose wait outlives its deadline raises the same way.

* **Per-session read-your-writes.**  A session writes through its own
  ``Session`` ticket scope; its RYW queries park until *that* ticket
  is applied, then ride a pinned snapshot that covers it.  Parked
  requests fail with ``UpdaterError`` if the updater dies.

Thread contract: any number of caller threads and sessions;
``dispatchers`` internal dispatcher threads (each with its own pinned
service reader, launching on the default stream of the service's
device); the service's one updater thread underneath.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Tuple

import numpy as np

from repro_torch.analysis.shadow import locks_required, make_condition
from repro_torch.serve.engine import (DEFAULT_BUCKETS, QueryEngine,
                                      coalesce_pairs, split_rows)
from repro_torch.serve.service import NO_TICKET, SPCService, UpdaterError

#: Consistency levels a front-door session may declare.
SESSION_CONSISTENCY = ("pinned", "read_your_writes")


class FrontDoorError(RuntimeError):
    """Base class of the front door's typed request failures."""


class Overloaded(FrontDoorError):
    """Admission control rejected the request: the pending queue
    already holds ``max_live_batches * max_batch`` worth of pairs.
    Retry with backoff, or build the door with more capacity."""


class DeadlineExceeded(FrontDoorError, TimeoutError):
    """The request's deadline/SLO expired before it was served (either
    while queued -- it was removed from the coalesced batch before
    dispatch -- or while parked on an unapplied read-your-writes
    ticket)."""


class _Request:
    """One caller's parked query: ``s``/``t`` pairs, the RYW ticket gate,
    the deadline, and the completion event the caller blocks on."""

    __slots__ = ("s", "t", "size", "min_ticket", "deadline", "done",
                 "dist", "cnt", "version", "error")

    def __init__(self, s, t, min_ticket: int, deadline: float) -> None:
        self.s = s
        self.t = t
        self.size = int(s.shape[0])
        self.min_ticket = int(min_ticket)
        self.deadline = float(deadline)
        self.done = threading.Event()
        self.dist = None
        self.cnt = None
        self.version = None
        self.error: BaseException | None = None

    def finish(self, dist, cnt, version) -> None:
        self.dist = dist
        self.cnt = cnt
        self.version = version
        self.done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()


class FrontDoorSession:
    """Per-caller handle: writes through an own ticket scope, reads
    through the coalescing queue.

    ``consistency="pinned"`` queries serve the currently published
    snapshot; ``"read_your_writes"`` queries park until this session's
    last submit ticket is applied, then serve a snapshot covering it --
    other sessions' writes never gate this session's reads.
    """

    def __init__(self, door: "FrontDoor",
                 consistency: str = "pinned") -> None:
        if consistency not in SESSION_CONSISTENCY:
            raise ValueError(
                f"unknown consistency {consistency!r}; want one of "
                f"{SESSION_CONSISTENCY}")
        self._door = door
        self._session = door.service.session()   # own ticket scope
        self.consistency = consistency

    @property
    def last_ticket(self) -> int:
        """This session's last accepted submit ticket (``NO_TICKET``
        if it never wrote)."""
        return self._session.last_ticket

    def submit(self, events, *, timeout: float | None = None) -> int:
        """Write path: ``service.submit`` credited to THIS session, so
        subsequent read-your-writes queries wait on exactly this
        ticket.  An empty chunk returns ``NO_TICKET`` and gates
        nothing."""
        return self._session.submit(events, timeout=timeout)

    def query(self, s: int, t: int, *,
              deadline: float | None = None) -> Tuple[int, int]:
        """One ``(s, t)`` query through the coalescing queue; blocks
        until a dispatcher serves the batch it rides (or the deadline
        expires)."""
        d, c = self.query_batch([s], [t], deadline=deadline)
        return int(d[0]), int(c[0])

    def query_batch(self, s, t, *, deadline: float | None = None):
        """A small list of pairs as one request (coalesced with other
        callers' requests up to the door's ``max_batch``).  Returns
        ``(dist int32[B], cnt int64[B])`` numpy arrays in request
        order."""
        min_ticket = (self._session.last_ticket
                      if self.consistency == "read_your_writes"
                      else NO_TICKET)
        return self._door._enqueue(s, t, min_ticket, deadline)


class FrontDoor:
    """Coalescing, admission-controlled request queue over an
    ``SPCService`` (see module doc; ``src/repro/serve/frontdoor.py:169``).

    Parameters:

    ``max_live_batches``
        Bound on admitted-but-unserved work, in batches; also the
        default dispatcher-thread count.  The pending queue holds at
        most ``max_live_batches * max_batch`` pairs -- past that,
        :class:`Overloaded`.
    ``max_batch``
        Pairs per coalesced dispatch (default: the engine's largest
        bucket, so one dispatch fills the top of the bucket ladder).
        Single requests larger than this are refused -- bulk analytics
        batches belong on ``SPCService.reader`` directly.
    ``dispatchers``
        Dispatcher threads (default ``max_live_batches``); each owns a
        pinned service reader built with ``route=``.
    ``deadline_s``
        Default per-request SLO; ``query(deadline=)`` overrides.
    ``gather_window_s``
        Optional wait after claiming a non-full batch, letting
        concurrent callers pile on before dispatch (0 = serve
        immediately; latency-vs-throughput knob).  Each dispatcher
        gathers independently, so the window coalesces best with a
        SMALL dispatcher count -- many dispatchers race to claim
        arrivals as fresh single-request batches instead of piling
        onto an open window.
    """

    def __init__(self, service: SPCService, *,
                 max_live_batches: int = 4,
                 max_batch: int | None = None,
                 max_queued: int | None = None,
                 dispatchers: int | None = None,
                 deadline_s: float = 30.0,
                 gather_window_s: float = 0.0,
                 route=None) -> None:
        if not isinstance(max_live_batches, int) or max_live_batches < 1:
            raise ValueError(
                f"max_live_batches must be >= 1, got {max_live_batches!r}")
        buckets = getattr(service, "_buckets", DEFAULT_BUCKETS)
        max_batch = int(buckets[-1] if max_batch is None else max_batch)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        dispatchers = (max_live_batches if dispatchers is None
                       else int(dispatchers))
        if dispatchers < 1:
            raise ValueError(f"dispatchers must be >= 1, got {dispatchers}")
        self.service = service
        self.max_live_batches = max_live_batches
        self.max_batch = max_batch
        self.max_queued = int(max_live_batches * max_batch
                              if max_queued is None else max_queued)
        self.dispatchers = dispatchers
        self.deadline_s = float(deadline_s)
        self.gather_window_s = float(gather_window_s)
        self._route = route
        self._cond = make_condition("frontdoor.cond")
        self._pending: deque = deque()    # admitted, unclaimed requests
        self._queued = 0                  # pairs in _pending
        self._live = 0                    # batches currently dispatching
        self._threads: list = []
        self._stop = False
        self._closed = False
        self._owns_service = False
        # -- counters (under _cond) -------------------------------------
        self._n_requests = 0              # admitted requests
        self._n_rejected = 0              # Overloaded admissions
        self._n_expired = 0               # deadline-failed requests
        self._n_batches = 0               # coalesced dispatches
        self._n_pairs = 0                 # pairs dispatched
        self._max_fill = 0                # largest coalesced batch

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
        """Launch the dispatcher threads (idempotent).  The underlying
        service keeps its own lifecycle -- start it too (or use
        ``service.start().frontdoor()``) or read-your-writes requests
        will park until their deadline."""
        with self._cond:
            if self._closed:
                raise RuntimeError("front door is closed")
            if not self._threads:
                self._threads = [
                    threading.Thread(target=self._dispatch_loop,
                                     name=f"spc-frontdoor-{i}", daemon=True)
                    for i in range(self.dispatchers)]
                for th in self._threads:
                    th.start()
        return self

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def close(self) -> None:
        """Stop the dispatchers and fail every still-parked request
        (typed ``FrontDoorError``); closes the owned service too when
        the door built it (``from_config``).  Safe to call twice."""
        with self._cond:
            self._stop = True
            self._closed = True
            orphans = list(self._pending)
            self._pending.clear()
            self._queued = 0
            threads = list(self._threads)
            self._cond.notify_all()
        err = FrontDoorError(
            "front door closed before the request was served")
        for req in orphans:
            req.fail(err)
        for th in threads:
            th.join(timeout=10.0)
        if self._owns_service:
            self.service.close()

    def _running(self) -> bool:
        with self._cond:
            return bool(self._threads) and not self._stop

    # -- caller side ---------------------------------------------------------
    def session(self, consistency: str = "pinned") -> FrontDoorSession:
        """A per-caller handle (see :class:`FrontDoorSession`)."""
        return FrontDoorSession(self, consistency)

    def _enqueue(self, s, t, min_ticket: int, deadline: float | None):
        """Admit one request (or reject typed), park the caller until a
        dispatcher completes it."""
        s = np.asarray(s).reshape(-1)
        t = np.asarray(t).reshape(-1)
        if s.shape != t.shape:
            raise ValueError(f"s/t shape mismatch: {s.shape} vs {t.shape}")
        size = int(s.shape[0])
        if size == 0:
            return (np.empty(0, np.int32), np.empty(0, np.int64))
        if size > self.max_batch:
            raise ValueError(
                f"request of {size} pairs exceeds the front door's "
                f"max_batch={self.max_batch}; large analytic batches "
                f"belong on SPCService.reader / query_batch directly")
        # per-request host-side id validation: a bad id fails THIS
        # caller synchronously instead of poisoning a coalesced batch
        QueryEngine._validate_ids(self.service.n, s, t)
        timeout = self.deadline_s if deadline is None else float(deadline)
        req = _Request(s, t, min_ticket, time.monotonic() + timeout)
        with self._cond:
            if self._closed:
                raise RuntimeError("front door is closed")
            if not self._threads:
                raise RuntimeError(
                    "front door not started: call start() (or use the "
                    "context manager) before querying")
            if self._queued + size > self.max_queued:
                self._n_rejected += 1
                raise Overloaded(
                    f"pending queue holds {self._queued} pairs, bound is "
                    f"{self.max_queued} (max_live_batches="
                    f"{self.max_live_batches} x max_batch="
                    f"{self.max_batch}); shed load or raise the bound")
            self._pending.append(req)
            self._queued += size
            self._n_requests += 1
            self._cond.notify()
        remaining = req.deadline - time.monotonic()
        if not req.done.wait(max(0.0, remaining)) and not req.done.is_set():
            raise DeadlineExceeded(
                f"request not served within its {timeout:.3f}s deadline "
                f"(queued behind {self.max_live_batches} live batches?)")
        if req.error is not None:
            raise req.error
        return req.dist, req.cnt

    # -- dispatcher side -----------------------------------------------------
    @locks_required("frontdoor.cond")
    def _take_ready(self, now: float, cap: int) -> list:
        """Claim up to ``cap`` pairs of ready requests, FIFO.  Holds
        ``_cond``.  Expired requests are failed HERE -- removed from
        the coalesced batch before dispatch; parked (RYW ticket not yet
        applied) requests stay queued; every parked-or-ready request is
        failed with ``UpdaterError`` when the updater died (its ticket
        would never apply, and the service refuses reads anyway)."""
        try:
            self.service.raise_if_failed()
        except UpdaterError as err:
            while self._pending:
                req = self._pending.popleft()
                self._queued -= req.size
                req.fail(err)
            return []
        applied = self.service.applied
        taken: list = []
        size = 0
        kept: deque = deque()
        while self._pending:
            req = self._pending.popleft()
            if now >= req.deadline:
                self._queued -= req.size
                self._n_expired += 1
                req.fail(DeadlineExceeded(
                    "deadline expired while queued; removed from the "
                    "batch before dispatch"))
                continue
            if req.min_ticket > applied:
                kept.append(req)       # parked on an unapplied ticket
                continue
            if size + req.size > cap:
                # batch full: keep FIFO order, stop scanning
                kept.append(req)
                kept.extend(self._pending)
                self._pending.clear()
                break
            taken.append(req)
            size += req.size
            self._queued -= req.size
        self._pending = kept
        return taken

    def _dispatch_loop(self) -> None:
        """One dispatcher: claim ready requests, coalesce, serve through
        a pinned reader, scatter per-request answers."""
        reader = self.service.reader("pinned", route=self._route)
        while True:
            with self._cond:
                while True:
                    if self._stop:
                        return
                    batch = self._take_ready(time.monotonic(),
                                             self.max_batch)
                    if batch:
                        break
                    # wake on arrivals; poll so parked tickets /
                    # deadlines are re-checked even with no new traffic
                    self._cond.wait(0.05)
                size = sum(r.size for r in batch)
                if self.gather_window_s > 0 and size < self.max_batch:
                    # throughput knob: let concurrent callers pile onto
                    # this batch for one short window
                    self._cond.wait(self.gather_window_s)
                    batch += self._take_ready(time.monotonic(),
                                              self.max_batch - size)
                    size = sum(r.size for r in batch)
                self._live += 1
                self._n_batches += 1
                self._n_pairs += size
                self._max_fill = max(self._max_fill, size)
            try:
                try:
                    s, t, offsets = coalesce_pairs(
                        [(r.s, r.t) for r in batch])
                    d, c = reader(s, t)   # pinned snapshot, bucket-padded
                    scattered = split_rows(d, c, offsets)
                except BaseException as e:
                    for req in batch:
                        req.fail(e)
                else:
                    version = reader.last_version
                    for req, (di, ci) in zip(batch, scattered):
                        req.finish(di, ci, version)
            finally:
                with self._cond:
                    self._live -= 1

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """One consistent view of the door's counters: admitted /
        rejected / expired requests, coalesced dispatches and fill,
        current queue depth and live batches."""
        with self._cond:
            batches = self._n_batches
            return {
                "requests": self._n_requests,
                "rejected": self._n_rejected,
                "expired": self._n_expired,
                "batches": batches,
                "pairs": self._n_pairs,
                "mean_fill": (self._n_pairs / batches) if batches else 0.0,
                "max_fill": self._max_fill,
                "queued": self._queued,
                "live": self._live,
            }

    # -- construction --------------------------------------------------------
    @classmethod
    def from_config(cls, config=None, *, service: SPCService | None = None,
                    device="cuda", **overrides) -> "FrontDoor":
        """Build from a ``configs/dspc.py`` shape: the front-door knobs
        (``max_live_batches`` / ``dispatchers`` / ``deadline_s`` /
        ``frontdoor_batch``) come from the config, keyword overrides
        win.  Without ``service=`` the whole stack is built on
        ``device`` via ``SPCService.from_config`` and owned (closed) by
        the door."""
        if config is None:
            from repro_torch.configs.dspc import CONFIG as config
        owns = service is None
        if owns:
            service = SPCService.from_config(config, device=device)
        kwargs = dict(
            max_live_batches=getattr(config, "max_live_batches", 4),
            dispatchers=getattr(config, "dispatchers", None),
            deadline_s=getattr(config, "deadline_s", 30.0),
            max_batch=getattr(config, "frontdoor_batch", None),
        )
        kwargs.update(overrides)
        door = cls(service, **kwargs)
        door._owns_service = owns
        return door
