"""Versioned snapshot publish: the update -> read coordination layer.

Port of ``repro.serve.publish``.  The updater stages
snapshot k + 1 outside the store's lock while readers keep their pinned
snapshot k; :meth:`SnapshotStore.publish` then swaps the front pointer
under ``store.lock`` and bumps a monotone version.  A non-increasing
version raises instead of rolling readers back.  Every committed swap is
forwarded to the transport (default :class:`LocalTransport`); the
reference's ``checkpoint_dir=`` / ``async_checkpoint=`` / ``keep=``
kwargs build the equivalent ``DirTransport``
(``src/repro/serve/publish.py:89-92``).

Producer side: ``DynamicSPC.attach_store()`` publishes after every
committed mutation or event chunk.  Consumer side: the service's
readers, ``QueryEngine.serve_from`` and the analytics layer pin
``store.current()``.

``mesh=`` (a ``repro_torch.launch.mesh.Mesh``) stages every snapshot
replicated over the serving mesh before the swap
(``repro_torch.core.distributed.replicate_index``: one copy per
distinct device), so sharded readers never copy mid-batch.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analysis.shadow import assert_no_locks_held, make_lock
from repro_torch.core.labels import SPCIndex
from repro_torch.serve.transport import (DirTransport, LocalTransport,
                                         Snapshot, SnapshotTransport)


class SnapshotStore:
    """Double-buffered, versioned SPCIndex snapshots (see module doc).

    Thread contract: one publisher (the updater), any number of readers.
    Readers pin with :meth:`current` and hold the returned ``Snapshot``
    for the duration of their work.  ``transport=`` plugs the medium
    every committed swap is forwarded through; ``checkpoint_dir=`` /
    ``async_checkpoint=`` / ``keep=`` build the equivalent
    ``DirTransport``; ``mesh=`` places each staged snapshot replicated
    over the mesh.
    """

    def __init__(self, index: SPCIndex | None = None, *, version: int = 0,
                 mesh=None, transport: SnapshotTransport | None = None,
                 checkpoint_dir: str | None = None,
                 async_checkpoint: bool = False, keep: int = 3) -> None:
        if transport is not None and checkpoint_dir is not None:
            raise ValueError(
                "pass transport= OR the legacy checkpoint_dir= shim, "
                "not both")
        if transport is None:
            transport = (DirTransport(checkpoint_dir, keep=keep,
                                      async_save=async_checkpoint)
                         if checkpoint_dir is not None else LocalTransport())
        self._lock = make_lock("store.lock")
        self._mesh = mesh
        self._transport = transport
        self._front: Optional[Snapshot] = None
        self.publishes = 0  # swap count (excludes the seed snapshot)
        if index is not None:
            self._front = Snapshot(int(version), self._stage(index))
            self._transport.publish(self._front)

    # -- reader side --------------------------------------------------------
    @property
    def version(self) -> int | None:
        """Version of the front snapshot (None while empty)."""
        with self._lock:
            snap = self._front
        return None if snap is None else snap.version

    @property
    def transport(self) -> SnapshotTransport:
        """The publication medium committed swaps are forwarded to."""
        return self._transport

    def current(self) -> Snapshot:
        """Pin the front snapshot: the returned object survives any
        later publish unchanged.  The read takes ``store.lock`` for one
        reference copy (the reference reads lock-free under the GIL)."""
        with self._lock:
            snap = self._front
        if snap is None:
            raise RuntimeError("SnapshotStore holds no published snapshot")
        return snap

    # -- publisher side -----------------------------------------------------
    def _stage(self, index: SPCIndex) -> SPCIndex:
        """Write the back buffer, outside the lock.  Without a mesh the
        published index is the updater's own (never written in place),
        so staging places nothing; with one, every distinct device of
        the mesh gets its copy here, on its current stream."""
        assert_no_locks_held("SnapshotStore._stage")
        if self._mesh is not None:
            from repro_torch.core.distributed import replicate_index
            index = replicate_index(self._mesh, index)
        return index

    def publish(self, index: SPCIndex, *, version: int | None = None) -> int:
        """Stage ``index`` and atomically swap it in at ``version``
        (default: front version + 1), then forward the committed
        snapshot through the transport.  Raises ``ValueError`` on a
        non-increasing version before anything is swapped or
        forwarded."""
        staged = self._stage(index)
        with self._lock:
            prev = -1 if self._front is None else self._front.version
            v = prev + 1 if version is None else int(version)
            if v <= prev:
                raise ValueError(
                    f"snapshot version must increase monotonically: "
                    f"got {v}, front is {prev}")
            snap = Snapshot(v, staged)
            self._front = snap
            self.publishes += 1
        # outside the lock: readers pinning the new front never wait on
        # the medium
        self._transport.publish(snap)
        return v

    def wait(self) -> None:
        """Settle an in-flight transport commit."""
        self._transport.wait()

    def close(self) -> None:
        """Settle and release the transport."""
        self._transport.close()
