"""The port's puller-fed replicas (``repro_torch.serve.replica``) and
``SPCService(role="replica")`` against the JAX package's, at the
``SMOKE`` configuration (n 64): a fleet across the two packages over
one ``DirTransport`` directory -- a JAX updater feeding a port replica
and a port updater feeding a JAX replica -- answers exactly as the
updater's own reader at every version; and the ``ReplicaGroup``
mechanics of ``tests/serve/test_replica.py`` (follow, verify before
staging, keep serving through failed pulls, skip and count a remote
behind, refuse a different graph).  Runs under the runtime shadow lock
checker; every wait is bounded."""

import time

import numpy as np
import pytest

from repro.serve import SPCService as JaxService
from repro_torch.configs.dspc import SMOKE
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import edge_set
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import (DirTransport, LocalTransport,
                               PublisherBehindError, ReplicaGroup,
                               ReplicaReadOnlyError, Snapshot, SnapshotStore,
                               SPCService, load_snapshot)

N, M, SEED = SMOKE.n, SMOKE.m, 3
WAIT = 20.0


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _edges():
    return random_graph_edges(N, M, seed=SEED)


def _bytes(idx):
    return {k: np.asarray(getattr(idx, k)).tobytes()
            for k in ("hub", "dist", "cnt", "size", "cnt_sum")}


def _absent_edge(spc):
    present = edge_set(spc.graph)
    return next((a, b) for a in range(spc.n) for b in range(a + 1, spc.n)
                if (a, b) not in present)


def _wait_for(pred, what):
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _pairs(rng, b=48):
    return rng.integers(0, N, b), rng.integers(0, N, b)


@pytest.mark.parametrize("updater_pkg", ["jax", "port"])
def test_cross_package_fleet_answers_as_the_updater(updater_pkg, tmp_path):
    """One package's updater publishes through a directory; the other
    package's replica pulls every version and answers each batch
    exactly as the updater's own pinned reader at that version."""
    d = str(tmp_path)
    common = dict(l_cap=SMOKE.l_cap, update_batch=4, transport="dir",
                  publish_dir=d, keep_published=2, wait_timeout=WAIT)
    if updater_pkg == "jax":
        updater = JaxService(N, _edges(), **common)
        replica = SPCService(role="replica", publish_dir=d,
                             poll_interval_s=0.01, wait_timeout=WAIT,
                             device="cpu")
        n_graph = DynamicSPC(N, _edges(), device="cpu")   # for the stream
    else:
        updater = SPCService(N, _edges(), device="cpu", **common)
        replica = JaxService(role="replica", publish_dir=d,
                             poll_interval_s=0.01, wait_timeout=WAIT)
        n_graph = updater.spc
    events = graph_stream(sorted(edge_set(n_graph.graph)), N, 6, 3,
                          seed=SEED + 1)
    rng = np.random.default_rng(0)
    with updater, replica:
        own = updater.reader("pinned")
        versions = []
        for lo in range(-3, len(events), 3):
            if lo >= 0:
                updater.submit(events[lo:lo + 3])
            updater.drain()
            replica.drain()
            assert replica.version == updater.version
            s, t = _pairs(rng)
            dw, cw = own(s, t)
            dg, cg = replica.query_batch(s, t)
            np.testing.assert_array_equal(np.asarray(dg), np.asarray(dw))
            np.testing.assert_array_equal(np.asarray(cg), np.asarray(cw))
            versions.append(replica.version)
        assert versions == [0, 1, 2, 3]
        assert replica.stats()["replica"]["errors"] == 0
        assert replica.stats()["replica"]["skipped_behind"] == 0


def test_group_follows_and_stages_on_its_device():
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    tr = LocalTransport()
    store = spc.attach_store(transport=tr)
    with ReplicaGroup(tr, poll_interval_s=0.01, device="cpu") as group:
        assert group.version == 0
        events = graph_stream(sorted(edge_set(spc.graph)), N, 4, 2, seed=5)
        spc.apply_events(events, batch_size=3)
        group.wait_for_version(store.version, timeout=WAIT)
        assert _bytes(group.store.current().index) == _bytes(spc.index)
        st = group.stats()
        assert st["version"] == store.version == 2 and st["errors"] == 0
        assert st["pulls"] >= 1 and st["sources"] == 1
        assert group._stage(store.current()) is store.current()
    # over a mesh the local store stages each pulled version
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with ReplicaGroup(tr, poll_interval_s=0.01, mesh=mesh,
                      device="cpu") as group:
        assert group.version == store.version
        assert group._stage(store.current()) is store.current()
        spc.apply_events(graph_stream(sorted(edge_set(spc.graph)), N, 2, 1,
                                      seed=6), batch_size=3)
        group.wait_for_version(store.version, timeout=WAIT)
        assert _bytes(group.store.current().index) == _bytes(spc.index)
    with pytest.raises(ValueError, match="at least one"):
        ReplicaGroup(device="cpu")


def test_group_start_times_out_without_publisher(tmp_path):
    group = ReplicaGroup(DirTransport(str(tmp_path), device="cpu"),
                         poll_interval_s=0.01, device="cpu")
    with pytest.raises(TimeoutError, match="updater up"):
        group.start(timeout=0.2)
    group.close()


def test_group_keeps_serving_through_failed_pulls(tmp_path):
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    store = spc.attach_store(transport=DirTransport(str(tmp_path)))
    with ReplicaGroup(DirTransport(str(tmp_path), device="cpu"),
                      poll_interval_s=0.01, device="cpu") as group:
        assert group.version == 0
        spc.apply_events([("+",) + _absent_edge(spc)], batch_size=1)
        payload = tmp_path / "step_000000001" / "arrays.npz"
        good = payload.read_bytes()
        payload.write_bytes(good[: len(good) // 2])
        _wait_for(lambda: group.stats()["errors"] > 0, "no failed pull")
        assert group.version == 0                    # still serving v0
        assert "000000001" in group.stats()["last_error"] or \
            "step 1" in group.stats()["last_error"]
        payload.write_bytes(good)                    # the medium heals
        group.wait_for_version(1, timeout=WAIT)
        assert _bytes(group.store.current().index) == _bytes(spc.index)
    assert store.version == 1


def test_group_skips_remote_behind(tmp_path):
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    spc.attach_store(transport=DirTransport(str(tmp_path)))
    spc.apply_events([("+",) + _absent_edge(spc)], batch_size=1)
    with ReplicaGroup(DirTransport(str(tmp_path), device="cpu"),
                      poll_interval_s=0.01, device="cpu") as group:
        group.wait_for_version(1, timeout=WAIT)
        served = _bytes(group.store.current().index)
        with open(tmp_path / "LATEST", "w") as f:
            f.write("0")                 # an out-of-protocol regression
        _wait_for(lambda: group.stats()["skipped_behind"] > 0,
                  "regression never seen")
        assert group.version == 1
        assert _bytes(group.store.current().index) == served


def test_group_rejects_a_different_graph():
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    tr = LocalTransport()
    spc.attach_store(transport=tr)
    other = DynamicSPC(8, [(0, 1), (1, 2)], l_cap=8, device="cpu")
    with ReplicaGroup(tr, poll_interval_s=0.01, device="cpu") as group:
        tr.publish(Snapshot(1, other.index))
        _wait_for(lambda: group.stats()["errors"] > 0, "never recorded")
        assert group.version == 0
        assert "different graph" in group.stats()["last_error"]


def test_restarted_publisher_reattaches_or_is_refused(tmp_path):
    d = str(tmp_path)
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    spc.attach_store(transport=DirTransport(d))
    spc.apply_events([("+",) + _absent_edge(spc)], batch_size=1)
    with ReplicaGroup(DirTransport(d, device="cpu"), poll_interval_s=0.01,
                      device="cpu") as group:
        group.wait_for_version(1, timeout=WAIT)
        snap = load_snapshot(d, device="cpu")
        store2 = SnapshotStore(snap.index, version=snap.version,
                               transport=DirTransport(d))
        assert store2.version == 1
        store2.publish(snap.index, version=2)
        group.wait_for_version(2, timeout=WAIT)
        assert group.stats()["skipped_behind"] == 0
        stale = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
        with pytest.raises(PublisherBehindError, match="restore"):
            stale.attach_store(transport=DirTransport(d))


def test_replica_service_is_read_only_and_validates(tmp_path):
    d = str(tmp_path)
    with SPCService(N, _edges(), l_cap=SMOKE.l_cap, transport="dir",
                    publish_dir=d, device="cpu") as updater:
        updater.drain()
    with SPCService(role="replica", publish_dir=d, poll_interval_s=0.01,
                    device="cpu", wait_timeout=WAIT) as replica:
        with pytest.raises(ReplicaReadOnlyError, match="updater host"):
            replica.submit([("+", 0, 1)])
        with pytest.raises(ReplicaReadOnlyError):
            replica.spc
        with pytest.raises(ReplicaReadOnlyError):
            replica.state_dict()
        assert replica.n == N and replica.replica_group is not None
        sess = replica.session()
        d_, _ = replica.reader("read_your_writes", session=sess)([0], [1])
        assert sess.last_ticket == 0 and d_.shape == (1,)
        with replica.frontdoor(max_batch=8, dispatchers=1) as door:
            assert door.session().query(0, 0) == (0, 1)
    with pytest.raises(ValueError, match="owns no updater"):
        SPCService(N, [(0, 1)], role="replica", publish_dir=d, device="cpu")
    with pytest.raises(ValueError, match="publication medium"):
        SPCService(role="replica", device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        SPCService(role="replica", publish_dir=d, checkpoint_dir=d,
                   device="cpu")
    with pytest.raises(ValueError, match="one or the other"):
        SPCService(N, [(0, 1)], publish_dir=d, checkpoint_dir=d,
                   device="cpu")
