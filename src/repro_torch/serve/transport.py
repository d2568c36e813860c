"""Snapshot transports: the publication medium between one publisher
and its readers.

Port of ``repro.serve.transport`` (``src/repro/serve/transport.py``):

===============  ==========================================  ==========
transport        medium                                      scope
===============  ==========================================  ==========
LocalTransport   in-process reference + notify condition     1 process
DirTransport     committed ``step_*`` dirs + ``LATEST``      N processes
                 pointer (``repro_torch.train.checkpoint``'s  on a shared
                 tmp + ``os.replace`` protocol)               filesystem
SocketTransport  DirTransport payload + a TCP doorbell        N hosts,
                 (the publisher broadcasts version bumps;     low-latency
                 pullers block on the socket)                 refresh
===============  ==========================================  ==========

A published snapshot keeps the reference's npz layout
(:func:`snapshot_tree`: ``index.{hub,dist,cnt,size,cnt_sum}`` and
``version``, sorted-key leaf order, metadata ``n``, ``l_cap`` and
``version``), so a JAX updater feeds a port replica and the reverse.
Tensors leave the device on the publishing thread; :func:`load_snapshot`
places a pulled snapshot on ``device=`` (default ``"cuda"``).

Version monotonicity is the safety argument: a transport refuses to
commit a version below the one it holds (:class:`PublisherBehindError`)
and treats a re-publish of the committed version as a no-op.  A reader
that loses its step dir to the publisher's retention gc gets the
checkpoint layer's typed ``SnapshotGoneError`` and :func:`load_snapshot`
retries against the new ``LATEST`` a bounded number of times.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.analysis.shadow import make_condition
from repro_torch.core.graph import resolve_device
from repro_torch.core.labels import SPCIndex
from repro_torch.train import checkpoint as C
from repro_torch.train.checkpoint import SnapshotGoneError  # noqa: F401

#: Bounded attempts of a fetch that keeps losing the gc race (each
#: retry re-reads ``LATEST``).
FETCH_RETRIES = 4

#: Name of the notify-endpoint file ``SocketTransport`` publishers drop
#: next to ``LATEST``.
NOTIFY_FILE = "NOTIFY"


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


def snapshot_tree(snap: Snapshot) -> dict:
    """Flat host-array dict of a snapshot (the checkpoint payload,
    ``src/repro/serve/transport.py:111``).  Dict trees flatten in
    sorted-key order, which lets :func:`load_snapshot` rebuild a
    template from the manifest's positional shapes and dtypes."""
    idx = snap.index
    return {
        "index.hub": idx.hub.cpu().numpy(),
        "index.dist": idx.dist.cpu().numpy(),
        "index.cnt": idx.cnt.cpu().numpy(),
        "index.size": idx.size.cpu().numpy(),
        "index.cnt_sum": idx.cnt_sum.cpu().numpy(),
        "version": np.int64(snap.version),
    }


_SNAPSHOT_KEYS = sorted(("index.hub", "index.dist", "index.cnt",
                         "index.size", "index.cnt_sum", "version"))


def _load_snapshot_once(path: str, step: int | None,
                        dev: torch.device) -> Snapshot:
    man = C.manifest(path, step)
    if len(man["shapes"]) != len(_SNAPSHOT_KEYS):
        raise ValueError(
            f"checkpoint at {path} has {len(man['shapes'])} leaves, "
            f"want {len(_SNAPSHOT_KEYS)} (not a snapshot checkpoint?)")
    tree_like = {
        k: np.empty(shape, dtype=np.dtype(dt))
        for k, shape, dt in zip(_SNAPSHOT_KEYS, man["shapes"],
                                man["dtypes"])
    }
    tree, got_step, meta = C.restore(path, tree_like, step=man["step"],
                                     device=dev)
    n = int(meta["n"])
    version = int(tree["version"])
    # manifest <-> payload verification BEFORE the snapshot is staged
    # anywhere a reader could pin it
    if version != got_step or int(meta.get("version", version)) != version:
        raise C.CheckpointCorruptError(
            path, got_step,
            f"payload version {version} does not match committed step "
            f"{got_step} / manifest version {meta.get('version')}")
    if int(tree["index.cnt_sum"].shape[0]) != n + 1:
        raise C.CheckpointCorruptError(
            path, got_step,
            f"cnt_sum has {tree['index.cnt_sum'].shape[0]} rows for "
            f"manifest n={n}")
    idx = SPCIndex(
        hub=tree["index.hub"], dist=tree["index.dist"],
        cnt=tree["index.cnt"], size=tree["index.size"],
        cnt_sum=tree["index.cnt_sum"],
        overflow=torch.zeros((), dtype=torch.int32, device=dev), n=n)
    return Snapshot(version=version, index=idx)


def load_snapshot(path: str, step: int | None = None,
                  retries: int = FETCH_RETRIES, *,
                  device="cuda") -> Snapshot:
    """Restore a published snapshot from a publication directory onto
    ``device`` (default: the latest committed version;
    ``src/repro/serve/transport.py:170``).

    Shapes come from the committed manifest, and the version is read
    from the payload and cross-checked against the committed step
    before anything is returned.  A reader racing the publisher's gc
    retries against the *new* ``LATEST`` (``retries`` bounded); an
    explicitly requested ``step=`` is never silently substituted: its
    loss raises ``SnapshotGoneError`` at once.
    """
    dev = resolve_device(device)
    attempts = max(1, int(retries))
    for attempt in range(attempts):
        try:
            return _load_snapshot_once(path, step, dev)
        except C.SnapshotGoneError:
            if step is not None or attempt == attempts - 1:
                raise
            # LATEST moved on while we were reading; take the new one
    raise AssertionError("unreachable")  # pragma: no cover


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
            raise C.SnapshotGoneError(
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


class DirTransport:
    """Committed ``step_*`` dirs + ``LATEST``: the cross-process medium
    over the checkpoint layer's tmp + ``os.replace`` protocol
    (``src/repro/serve/transport.py:300``).

    ``keep=`` bounds the publisher's retention window (gc never deletes
    the step ``LATEST`` names); ``async_save=True`` moves serialization
    onto the checkpoint layer's saver thread (failures re-raised on the
    next publish / wait).  Pulled snapshots are placed on ``device``,
    which is resolved at the first fetch, so a publisher needs no card.
    """

    def __init__(self, path: str, *, keep: int = 3,
                 async_save: bool = False, device="cuda") -> None:
        if not path:
            raise ValueError("DirTransport needs a publication directory")
        self.path = str(path)
        self.device = device  # resolved by the first fetch
        self._keep = int(keep)
        self._saver = C.AsyncSaver() if async_save else None

    # -- publisher side -----------------------------------------------------
    def publish(self, snapshot: Snapshot) -> None:
        committed = C.latest_step(self.path)
        if committed is not None:
            if snapshot.version < committed:
                raise PublisherBehindError(
                    snapshot.version, committed, self.path)
            if snapshot.version == committed:
                return  # correctly-restored updater re-attaching: no-op
        tree = snapshot_tree(snapshot)
        meta = {"n": snapshot.index.n, "l_cap": snapshot.index.l_cap,
                "version": snapshot.version}
        if self._saver is not None:
            self._saver.save(self.path, snapshot.version, tree, meta)
        else:
            C.save(self.path, snapshot.version, tree, meta)
        # an in-flight async write lives in a .tmp dir, invisible to gc
        C.gc_old(self.path, keep=self._keep)

    def wait(self) -> None:
        if self._saver is not None:
            self._saver.wait()

    # -- puller side --------------------------------------------------------
    def poll(self) -> int | None:
        return C.latest_step(self.path)

    def fetch(self, version: int | None = None) -> Snapshot:
        return load_snapshot(self.path, step=version, device=self.device)

    def wait_notify(self, timeout: float) -> bool:
        time.sleep(max(0.0, timeout))  # pure polling medium
        return False

    def close(self) -> None:
        self.wait()


class SocketTransport:
    """``DirTransport`` payload + a thin TCP notify channel
    (``src/repro/serve/transport.py:362``).

    The publisher binds an ephemeral TCP port, drops its address in
    ``<dir>/NOTIFY`` and broadcasts one ``<version>\\n`` line per
    publish; pullers connect lazily and block on the socket in
    :meth:`wait_notify` instead of sleeping out a poll interval.  The
    socket is only a doorbell: versions and payloads are read from the
    committed directory, so a dropped connection degrades to polling,
    never to wrong data.  Every socket attribute is read and swapped
    under ``transport.cond``.
    """

    def __init__(self, path: str, *, keep: int = 3,
                 async_save: bool = False, host: str = "127.0.0.1",
                 device="cuda") -> None:
        self._dir = DirTransport(path, keep=keep, async_save=async_save,
                                 device=device)
        self.path = self._dir.path
        self._host = host
        self._cond = make_condition("transport.cond")
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._clients: list = []
        self._conn: Optional[socket.socket] = None
        self._closed = False

    # -- publisher side -----------------------------------------------------
    def _ensure_server(self) -> None:
        with self._cond:
            if self._server is not None or self._closed:
                return
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self._host, 0))
            srv.listen(16)
            self._server = srv
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="snapshot-notify-accept",
                daemon=True)
            self._accept_thread.start()
        host, port = srv.getsockname()
        os.makedirs(self.path, exist_ok=True)
        tmp = os.path.join(self.path, NOTIFY_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(f"{host}:{port}")
        os.replace(tmp, os.path.join(self.path, NOTIFY_FILE))

    def _accept_loop(self) -> None:
        with self._cond:
            srv = self._server
        if srv is None:
            return  # closed before this thread ran
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return  # server closed
            with self._cond:
                if self._closed:
                    conn.close()
                    return
                self._clients.append(conn)

    def publish(self, snapshot: Snapshot) -> None:
        self._ensure_server()
        self._dir.publish(snapshot)
        line = f"{snapshot.version}\n".encode()
        with self._cond:
            clients = list(self._clients)
        dead = []
        for conn in clients:
            try:
                conn.sendall(line)
            except OSError:
                dead.append(conn)
        if dead:
            with self._cond:
                for conn in dead:
                    if conn in self._clients:
                        self._clients.remove(conn)
            for conn in dead:
                conn.close()

    def wait(self) -> None:
        self._dir.wait()

    # -- puller side --------------------------------------------------------
    def _connect(self) -> Optional[socket.socket]:
        with self._cond:
            if self._conn is not None or self._closed:
                return self._conn
        ep = os.path.join(self.path, NOTIFY_FILE)
        try:
            with open(ep) as f:
                host, port = f.read().strip().rsplit(":", 1)
            conn = socket.create_connection((host, int(port)), timeout=1.0)
        except (OSError, ValueError):
            return None  # no publisher up yet: degrade to polling
        with self._cond:
            if self._closed:
                conn.close()
                return None
            self._conn = conn
        return conn

    def poll(self) -> int | None:
        return self._dir.poll()

    def fetch(self, version: int | None = None) -> Snapshot:
        return self._dir.fetch(version)

    def wait_notify(self, timeout: float) -> bool:
        conn = self._connect()
        if conn is None:
            time.sleep(max(0.0, timeout))
            return False
        conn.settimeout(max(0.01, timeout))
        try:
            data = conn.recv(64)
        except socket.timeout:
            return False
        except OSError:
            data = b""
        if not data:  # publisher went away: reconnect on the next wait
            with self._cond:
                if self._conn is conn:
                    self._conn = None
            conn.close()
            return False
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            server, self._server = self._server, None
            conn, self._conn = self._conn, None
            clients, self._clients = list(self._clients), []
        for sock in [server, conn, *clients]:
            if sock is not None:
                try:
                    sock.close()
                except OSError:  # pragma: no cover - teardown best-effort
                    pass
        self._dir.close()


#: Transport spec names accepted by :func:`make_transport` (and the
#: ``transport=`` config knob).
TRANSPORTS = ("local", "dir", "socket")


def make_transport(spec, *, publish_dir: str | None = None,
                   keep: int = 3, async_save: bool = False, device="cuda"):
    """Build a transport from a config spec: an instance passes
    through; ``"local"`` / ``"dir"`` / ``"socket"`` construct one (the
    latter two need ``publish_dir=`` and pull onto ``device``)."""
    if spec is None:
        spec = "local"
    if not isinstance(spec, str):
        return spec  # an already-built transport object
    if spec not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {spec!r}; want one of {TRANSPORTS} "
            f"(or a SnapshotTransport instance)")
    if spec == "local":
        return LocalTransport()
    if publish_dir is None:
        raise ValueError(
            f"transport {spec!r} publishes through a directory; pass "
            f"publish_dir=")
    cls = DirTransport if spec == "dir" else SocketTransport
    return cls(publish_dir, keep=keep, async_save=async_save, device=device)
