"""Snapshot transports: the publication medium between one publisher
and its readers.

Port of the in-process part of ``repro.serve.transport``: the
:class:`Snapshot` record, the :class:`SnapshotTransport` protocol, the
typed errors and :class:`LocalTransport`.  The cross-process media
(``DirTransport``, ``SocketTransport``) and ``load_snapshot`` need the
checkpoint port and belong to a later slice.

Version monotonicity is the safety argument: a transport refuses to
commit a version below the one it holds (:class:`PublisherBehindError`)
and treats a re-publish of the committed version as a no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

from repro_torch.analysis.shadow import make_condition
from repro_torch.core.labels import SPCIndex


class TransportError(RuntimeError):
    """Base class of typed transport failures."""


class PublisherBehindError(TransportError):
    """A (restarted) publisher asked to commit a version at or below a
    different already-committed one -- accepting it would roll every
    reader back.  Restore the updater from the published snapshot
    instead."""

    def __init__(self, version: int, committed: int, where: str) -> None:
        self.version = version
        self.committed = committed
        super().__init__(
            f"publisher is behind the committed publication stream at "
            f"{where}: asked to publish version {version} but version "
            f"{committed} is already committed; a restarted updater "
            f"must restore from the published snapshot, not re-publish "
            f"history")


class SnapshotGoneError(FileNotFoundError):
    """The requested version is no longer the committed one (the
    reference raises its checkpoint layer's error of the same name)."""

    def __init__(self, path: str, step: int, detail: str = "") -> None:
        self.path = path
        self.step = step
        super().__init__(
            f"snapshot version {step} under {path} is gone"
            f"{': ' + detail if detail else ''}")


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable published (version, index) pair.

    Holding a ``Snapshot`` is the pin.  JAX arrays are immutable; torch
    tensors are not, so the pin holds only because nothing writes a
    published index in place: every update engine of
    ``repro_torch.core`` returns new tensors and leaves its input
    untouched (``tests/test_torch_publish.py`` holds a pinned snapshot
    byte for byte across ``apply_events``).
    """

    version: int
    index: SPCIndex


@runtime_checkable
class SnapshotTransport(Protocol):
    """The publication medium between ONE publisher and N pullers.

    ``publish(snapshot)`` commits atomically and notifies; it raises
    :class:`PublisherBehindError` below the committed version and is a
    no-op at it.  ``wait()`` settles an asynchronous commit.
    ``poll()`` returns the committed version (None while empty),
    ``fetch(version=None)`` the committed snapshot, and
    ``wait_notify(timeout)`` blocks until a publish (probably) arrived.
    ``close()`` releases what the medium holds.
    """

    def publish(self, snapshot: Snapshot) -> None: ...

    def wait(self) -> None: ...

    def poll(self) -> int | None: ...

    def fetch(self, version: int | None = None) -> Snapshot: ...

    def wait_notify(self, timeout: float) -> bool: ...

    def close(self) -> None: ...


class LocalTransport:
    """The in-process medium (the default): one reference slot guarded
    by a condition; publish stores the snapshot and notifies.  The
    committed version is kept beside the slot as a plain int."""

    def __init__(self) -> None:
        self._cond = make_condition("transport.cond")
        self._snap: Optional[Snapshot] = None
        self._committed: Optional[int] = None

    def publish(self, snapshot: Snapshot) -> None:
        version = snapshot.version
        with self._cond:
            committed = self._committed
            if committed is not None and version < committed:
                raise PublisherBehindError(version, committed,
                                           "LocalTransport")
            if committed is not None and version == committed:
                return  # idempotent re-publish of the committed version
            self._snap, self._committed = snapshot, version
            self._cond.notify_all()

    def wait(self) -> None:  # synchronous medium: nothing in flight
        return

    def poll(self) -> int | None:
        with self._cond:
            return self._committed

    def fetch(self, version: int | None = None) -> Snapshot:
        with self._cond:
            snap, committed = self._snap, self._committed
        if snap is None:
            raise FileNotFoundError(
                "LocalTransport holds no published snapshot")
        if version is not None and committed != version:
            raise SnapshotGoneError(
                "<local>", version, f"committed version is {committed}")
        return snap

    def wait_notify(self, timeout: float) -> bool:
        with self._cond:
            start = self._committed
            self._cond.wait(timeout)
            now = self._committed
        return now != start

    def close(self) -> None:
        return
