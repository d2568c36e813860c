"""Puller-fed serving replicas: the remote end of the publication pipe.

Port of ``repro.serve.replica`` (``src/repro/serve/replica.py``).  One
updater publishes versioned snapshots through a ``SnapshotTransport``;
a :class:`ReplicaGroup` runs one puller thread per source transport
that

1. **polls / subscribes** -- ``wait_notify`` blocks on the medium's
   doorbell or sleeps out ``poll_interval_s`` on pure-polling media;
2. **verifies before staging** -- the fetch cross-checks the committed
   manifest against the payload (leaf count, version == step,
   ``cnt_sum`` rows), and the group refuses a snapshot whose vertex
   count differs from what it serves;
3. **stages onto its device and swaps locally** -- a snapshot pulled
   onto another device is copied onto the group's ``device`` (with
   ``mesh=``, replicated over the serving mesh by the local store)
   before it is published into the group's own ``SnapshotStore``, so
   local readers keep the pin-per-batch contract;
4. **keeps serving through puller failures** -- a failed pull is
   recorded and retried, never propagated to readers;
5. **re-attaches to a restarted updater** -- a remote pointer behind
   the local version is skipped and counted (``skipped_behind``).

Thread contract: puller threads touch only their own bookkeeping under
``replica.lock`` and never hold it across a fetch or a local publish.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

from repro_torch.analysis.shadow import make_lock
from repro_torch.core.graph import resolve_device
from repro_torch.serve.publish import SnapshotStore
from repro_torch.serve.transport import Snapshot, SnapshotTransport

_log = logging.getLogger(__name__)


class ReplicaGroup:
    """A local ``SnapshotStore`` continuously fed by puller threads
    (``src/repro/serve/replica.py:52``).

    ``transports`` are the remote publication media to follow (one
    puller thread each; the store's monotone version makes several
    sources safe).  ``poll_interval_s`` bounds staleness on polling
    media and is the doorbell wait on subscribing ones.  Pulled
    snapshots are staged onto ``device`` (default ``"cuda"``); with
    ``mesh=`` the local store stages each one replicated over the
    serving mesh instead (``core.distributed.replicate_index``).

    Lifecycle: :meth:`start` blocks (bounded) until the first snapshot
    is pulled, then keeps pulling in the background until
    :meth:`close`.
    """

    def __init__(self, *transports: SnapshotTransport,
                 poll_interval_s: float = 0.05, mesh=None,
                 device="cuda") -> None:
        if not transports:
            raise ValueError("ReplicaGroup needs at least one transport")
        if poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {poll_interval_s!r}")
        self.device = resolve_device(device)
        self._transports = tuple(transports)
        self.poll_interval_s = float(poll_interval_s)
        self._mesh = mesh
        self._store = SnapshotStore(mesh=mesh)
        self._lock = make_lock("replica.lock")
        self._stop = threading.Event()
        self._threads: list = []
        self._started = False
        self._closed = False
        # -- bookkeeping (under replica.lock) ---------------------------
        self._pulls = 0            # snapshots staged + swapped locally
        self._skipped_behind = 0   # remote versions <= local (restart race)
        self._errors = 0           # failed pull attempts (retried)
        self._last_error: Optional[BaseException] = None

    # -- reader side ---------------------------------------------------------
    @property
    def store(self) -> SnapshotStore:
        """The local store readers pin batches against."""
        return self._store

    @property
    def version(self) -> int | None:
        """Version currently served locally (None before the first
        pull)."""
        return self._store.version

    def stats(self) -> dict:
        """Frozen view of the puller bookkeeping."""
        version = self._store.version
        with self._lock:
            return {
                "version": version,
                "pulls": self._pulls,
                "skipped_behind": self._skipped_behind,
                "errors": self._errors,
                "last_error": (None if self._last_error is None
                               else repr(self._last_error)),
                "sources": len(self._transports),
            }

    # -- puller side ---------------------------------------------------------
    def _record(self, *, pulls: int = 0, skipped: int = 0,
                error: BaseException | None = None) -> None:
        with self._lock:
            self._pulls += pulls
            self._skipped_behind += skipped
            if error is not None:
                self._errors += 1
                self._last_error = error

    def _stage(self, snap: Snapshot) -> Snapshot:
        """The pulled snapshot on this group's device (a copy when the
        medium delivered it elsewhere); over a mesh the local store
        places it."""
        idx = snap.index
        if self._mesh is not None or idx.device == self.device:
            return snap
        moved = dataclasses.replace(idx, **{
            f.name: getattr(idx, f.name).to(self.device)
            for f in dataclasses.fields(idx) if f.name != "n"})
        return Snapshot(snap.version, moved)

    def _pull_once(self, transport: SnapshotTransport) -> bool:
        """One poll -> verify -> stage -> swap attempt; True if a new
        version went live locally."""
        remote = transport.poll()
        local = self._store.version
        if remote is None:
            return False
        if local is not None and remote <= local:
            if remote < local:
                # a restarted updater behind this replica: never applied
                self._record(skipped=1)
            return False
        snap = self._stage(transport.fetch(remote))  # verified by fetch
        current = None if local is None else self._store.current()
        if current is not None and snap.index.n != current.index.n:
            raise ValueError(
                f"pulled snapshot v{snap.version} has n={snap.index.n} "
                f"but this replica serves n={current.index.n}; refusing "
                f"to stage a different graph's index")
        try:
            self._store.publish(snap.index, version=snap.version)
        except ValueError:
            # another puller of this group won the race to an equal or
            # newer version while we fetched; their snapshot serves
            self._record(skipped=1)
            return False
        self._record(pulls=1)
        return True

    def _run(self, transport: SnapshotTransport) -> None:
        while not self._stop.is_set():
            try:
                advanced = self._pull_once(transport)
            except BaseException as e:
                # a failed pull never stops serving: record, retry
                self._record(error=e)
                _log.warning("replica pull failed (still serving v%s): %r",
                             self._store.version, e)
                advanced = False
            if not advanced and not self._stop.is_set():
                transport.wait_notify(self.poll_interval_s)

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout: float | None = 60.0) -> "ReplicaGroup":
        """Pull the first snapshot (blocking, bounded by ``timeout``;
        ``None`` waits forever) and launch the puller threads.
        Idempotent."""
        if self._closed:
            raise RuntimeError("replica group is closed")
        if self._started:
            return self
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while self._store.version is None:
            for transport in self._transports:
                try:
                    if self._pull_once(transport):
                        break
                except BaseException as e:
                    self._record(error=e)
            if self._store.version is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no published snapshot appeared on any of "
                    f"{len(self._transports)} transport(s) within "
                    f"{timeout:.1f}s; is the updater up and publishing?")
            self._transports[0].wait_notify(
                min(self.poll_interval_s, 0.05))
        self._threads = [
            threading.Thread(target=self._run, args=(transport,),
                             name=f"snapshot-puller-{i}", daemon=True)
            for i, transport in enumerate(self._transports)]
        for th in self._threads:
            th.start()
        self._started = True
        return self

    def __enter__(self) -> "ReplicaGroup":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_for_version(self, version: int,
                         timeout: float | None = 60.0) -> None:
        """Block until the locally served version reaches ``version``."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            local = self._store.version
            if local is not None and local >= version:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replica still at version {local} after "
                    f"{timeout:.1f}s waiting for version {version}")
            time.sleep(min(self.poll_interval_s, 0.02))

    def catch_up(self, timeout: float | None = 60.0) -> None:
        """Block until the local version covers every source's
        currently committed version (the replica-side ``drain``);
        unreachable sources are skipped."""
        target = None
        for transport in self._transports:
            try:
                remote = transport.poll()
            except OSError as e:  # pragma: no cover - medium unreachable
                self._record(error=e)
                continue
            if remote is not None:
                target = remote if target is None else max(target, remote)
        if target is not None:
            self.wait_for_version(target, timeout)

    def close(self) -> None:
        """Stop the pullers and release the transports; the local store
        keeps serving whatever it last swapped in."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5.0)
            if th.is_alive():  # pragma: no cover - hung medium
                _log.warning("puller thread %s did not stop", th.name)
        for transport in self._transports:
            transport.close()
