"""The port's snapshot transports (``repro_torch.serve.transport``)
against the JAX package's: snapshots published by either package's
``DirTransport`` load in the other byte for byte (the npz layout of
``src/repro/serve/transport.py:111``), and the reference's behaviour as
``tests/serve/test_transport.py`` checks it: publisher-side
monotonicity, the retention window pinned by ``LATEST``, gc-race
retries, manifest <-> payload verification, the socket doorbell and
``make_transport``.  Runs under the runtime shadow lock checker."""

import os
import threading
import time

import numpy as np
import pytest

from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.data import graph_stream, random_graph_edges
from repro.serve import transport as JT
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import edge_set
from repro_torch.serve.transport import (FETCH_RETRIES, NOTIFY_FILE,
                                         TRANSPORTS, DirTransport,
                                         LocalTransport,
                                         PublisherBehindError, Snapshot,
                                         SnapshotTransport, SocketTransport,
                                         TransportError, load_snapshot,
                                         make_transport, snapshot_tree)
from repro_torch.train import checkpoint as C

N, M, SEED = 16, 36, 13
FIELDS = ("hub", "dist", "cnt", "size", "cnt_sum")


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _bytes(idx):
    return {k: np.asarray(getattr(idx, k)).tobytes() for k in FIELDS}


def _dtypes(idx):
    return {k: str(np.asarray(getattr(idx, k)).dtype) for k in FIELDS}


@pytest.fixture(scope="module")
def streams():
    """(port snapshots, JAX snapshots): the same 3 versions in both
    packages (the index after 0, 1 and 2 committed chunks)."""
    edges = random_graph_edges(N, M, seed=SEED)
    spc = DynamicSPC(N, edges, l_cap=32, device="cpu")
    ref = JaxDSPC(N, edges, l_cap=32)
    events = graph_stream(sorted(edge_set(spc.graph)), N, 4, 2,
                          seed=SEED + 1)
    ours, theirs = [Snapshot(0, spc.index)], [JT.Snapshot(0, ref.index)]
    for k in (1, 2):
        chunk = events[3 * (k - 1):3 * k]
        spc.apply_events(chunk, batch_size=3)
        ref.apply_events(chunk, batch_size=3)
        ours.append(Snapshot(k, spc.index))
        theirs.append(JT.Snapshot(k, ref.index))
    for a, b in zip(ours, theirs):
        assert _bytes(a.index) == _bytes(b.index)
    return ours, theirs


def test_jax_published_snapshots_load_in_the_port(streams, tmp_path):
    ours, theirs = streams
    tr = JT.DirTransport(str(tmp_path), keep=3)
    for snap in theirs:
        tr.publish(snap)
    for k in (None, 0, 1, 2):
        got = load_snapshot(str(tmp_path), step=k, device="cpu")
        want = theirs[2 if k is None else k]
        assert got.version == want.version
        assert _bytes(got.index) == _bytes(want.index)
        assert _dtypes(got.index) == _dtypes(want.index)
        assert got.index.n == N and int(got.index.overflow) == 0
    fetched = DirTransport(str(tmp_path), device="cpu").fetch()
    assert _bytes(fetched.index) == _bytes(ours[2].index)


def test_port_published_snapshots_load_in_jax(streams, tmp_path):
    ours, theirs = streams
    tr = DirTransport(str(tmp_path), keep=3, async_save=True)
    for snap in ours:
        tr.publish(snap)
    tr.wait()
    for k in (0, 1, 2):
        got = JT.load_snapshot(str(tmp_path), step=k)
        assert got.version == k
        assert _bytes(got.index) == _bytes(theirs[k].index)
        assert _dtypes(got.index) == _dtypes(theirs[k].index)
    man = C.manifest(str(tmp_path))
    assert man["metadata"] == {"n": N, "l_cap": 32, "version": 2}
    tree = JT.snapshot_tree(theirs[1])
    mine = snapshot_tree(ours[1])
    assert sorted(mine) == sorted(tree)
    for key in tree:
        assert np.asarray(mine[key]).tobytes() == \
            np.asarray(tree[key]).tobytes(), key


def test_local_transport_round_trip(streams):
    ours, _ = streams
    tr = LocalTransport()
    assert tr.poll() is None
    with pytest.raises(FileNotFoundError):
        tr.fetch()
    for snap in ours:
        tr.publish(snap)
        assert tr.poll() == snap.version
    assert tr.fetch().index is ours[2].index
    with pytest.raises(C.SnapshotGoneError):
        tr.fetch(0)
    with pytest.raises(PublisherBehindError) as ei:
        tr.publish(ours[1])
    assert (ei.value.version, ei.value.committed) == (1, 2)
    assert isinstance(ei.value, TransportError)


def test_local_transport_notify_wakes_waiter(streams):
    ours, _ = streams
    tr = LocalTransport()
    tr.publish(ours[0])
    woke = []
    th = threading.Thread(target=lambda: woke.append(tr.wait_notify(5.0)))
    th.start()
    time.sleep(0.05)
    tr.publish(ours[1])
    th.join(timeout=5.0)
    assert woke == [True]
    assert tr.wait_notify(0.01) is False


def test_dir_transport_retention_pins_latest(streams, tmp_path):
    ours, _ = streams
    tr = DirTransport(str(tmp_path), keep=1, device="cpu")
    for snap in ours:
        tr.publish(snap)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000002"]
    assert tr.fetch().version == 2
    with pytest.raises(C.SnapshotGoneError):
        tr.fetch(1)


def test_dir_transport_publisher_behind(streams, tmp_path):
    ours, theirs = streams
    JT.DirTransport(str(tmp_path)).publish(theirs[2])
    fresh = DirTransport(str(tmp_path))        # a restarted port updater
    with pytest.raises(PublisherBehindError, match="restore from the"):
        fresh.publish(ours[1])
    assert C.latest_step(str(tmp_path)) == 2
    before = os.path.getmtime(tmp_path / "step_000000002" / "arrays.npz")
    fresh.publish(ours[2])                     # idempotent re-publish
    assert os.path.getmtime(
        tmp_path / "step_000000002" / "arrays.npz") == before


def test_load_snapshot_retries_against_new_latest(streams, tmp_path,
                                                  monkeypatch):
    ours, _ = streams
    tr = DirTransport(str(tmp_path))
    for snap in ours[:2]:
        tr.publish(snap)
    real = C.manifest
    calls = []

    def racing_manifest(path, step=None):
        calls.append(step)
        if len(calls) == 1:  # the step vanished under the first read
            raise C.SnapshotGoneError(path, 0, "gc race (test)")
        return real(path, step)

    monkeypatch.setattr(C, "manifest", racing_manifest)
    assert load_snapshot(str(tmp_path), device="cpu").version == 1
    assert len(calls) == 2
    calls.clear()
    monkeypatch.setattr(C, "manifest", lambda path, step=None: (
        calls.append(step), real(path, step))[1])
    with pytest.raises(C.SnapshotGoneError) as ei:
        load_snapshot(str(tmp_path), step=7, device="cpu")
    assert ei.value.step == 7 and len(calls) == 1 and FETCH_RETRIES >= 1


def test_load_snapshot_verifies_before_staging(streams, tmp_path):
    ours, _ = streams
    C.save(str(tmp_path / "foreign"), 0, {"weights": np.zeros(4)})
    with pytest.raises(ValueError, match="not a snapshot checkpoint"):
        load_snapshot(str(tmp_path / "foreign"), device="cpu")
    tree = snapshot_tree(ours[0])
    C.save(str(tmp_path / "odd"), 5, tree,
           {"n": N, "l_cap": 32, "version": 5})
    with pytest.raises(C.CheckpointCorruptError, match="does not match"):
        load_snapshot(str(tmp_path / "odd"), device="cpu")
    C.save(str(tmp_path / "rows"), 0, tree,
           {"n": N + 1, "l_cap": 32, "version": 0})
    with pytest.raises(C.CheckpointCorruptError, match="cnt_sum"):
        load_snapshot(str(tmp_path / "rows"), device="cpu")


def test_socket_transport_notify_and_payload(streams, tmp_path):
    ours, _ = streams
    pub = SocketTransport(str(tmp_path))
    sub = SocketTransport(str(tmp_path), device="cpu")
    try:
        pub.publish(ours[0])
        assert os.path.exists(tmp_path / NOTIFY_FILE)
        assert sub.poll() == 0
        stop = threading.Event()

        def republisher():
            while not stop.is_set():
                pub.publish(ours[1])
                time.sleep(0.02)

        th = threading.Thread(target=republisher, daemon=True)
        th.start()
        try:
            deadline = time.monotonic() + 10.0
            notified = False
            while not notified and time.monotonic() < deadline:
                notified = sub.wait_notify(0.5)
            assert notified, "doorbell never rang"
        finally:
            stop.set()
            th.join(timeout=5.0)
        assert sub.poll() == 1
        assert _bytes(sub.fetch().index) == _bytes(ours[1].index)
    finally:
        sub.close()
        pub.close()
    lone = SocketTransport(str(tmp_path / "empty"))
    t0 = time.monotonic()
    assert lone.wait_notify(0.05) is False and lone.poll() is None
    assert time.monotonic() - t0 >= 0.04       # degraded to polling
    lone.close()


def test_make_transport_coercions(tmp_path):
    assert isinstance(make_transport(None), LocalTransport)
    tr = make_transport("dir", publish_dir=str(tmp_path), keep=5,
                        device="cpu")
    assert isinstance(tr, DirTransport) and tr._keep == 5
    sock = make_transport("socket", publish_dir=str(tmp_path))
    assert isinstance(sock, SocketTransport)
    sock.close()
    passthrough = LocalTransport()
    assert make_transport(passthrough) is passthrough
    with pytest.raises(ValueError, match="publish_dir"):
        make_transport("dir")
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("carrier-pigeon")
    assert TRANSPORTS == JT.TRANSPORTS
    for t in (LocalTransport(), DirTransport(str(tmp_path))):
        assert isinstance(t, SnapshotTransport)
