"""The port's ``SPCService`` (``repro_torch.serve.service``) against the
JAX package's at the ``SMOKE`` configuration (n 64): the same tickets
leave ``state_dict()`` byte-identical and every consistency level gives
the reference's answers; checkpoints of either package's state restore
the other's service; and the reference's contract as
``tests/serve/test_service.py`` checks it -- consistency levels,
bounded ingest and backpressure, ``UpdaterError`` propagation, session
scoping, the ticket history, the lifecycle and the stats.  Runs under
the runtime shadow lock checker; every wait is bounded."""

import dataclasses
import os
import queue as queue_lib
import threading
import time

import numpy as np
import pytest

from repro.serve import SPCService as JaxService
from repro.train import checkpoint as JC
from repro_torch.configs.dspc import SMOKE
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.graph import edge_set
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import (CONSISTENCY_LEVELS, NO_TICKET, ROLES,
                               RoutePolicy, ServeStats, SPCService,
                               UpdaterError)
from repro_torch.train import checkpoint as C

N, M, SEED = SMOKE.n, SMOKE.m, 3
WAIT = 20.0


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _edges():
    return random_graph_edges(N, M, seed=SEED)


def _service(**kw):
    kw.setdefault("l_cap", SMOKE.l_cap)
    kw.setdefault("wait_timeout", WAIT)
    return SPCService(N, _edges(), device="cpu", **kw)


def _stream(svc, n_ins, n_del, seed):
    return graph_stream(sorted(edge_set(svc.spc.graph)), N, n_ins, n_del,
                        seed=seed)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _assert_oracle(svc, d, c, s, t):
    for k, (sk, tk) in enumerate(zip(s, t)):
        res = plain_spc_bfs(svc.spc.graph, int(sk))
        assert (int(d[k]), int(c[k])) == (int(res.dist[tk]),
                                          int(res.cnt[tk]))


# -- parity with the reference -----------------------------------------------
def test_same_tickets_leave_reference_state_and_answers():
    """Both packages' services ingest the same tickets through their
    updater threads: byte-identical ``state_dict()`` after every drain,
    the same versions, and equal answers on every consistency level."""
    ours = SPCService.from_config(SMOKE, edges=_edges(), device="cpu",
                                  wait_timeout=WAIT)
    theirs = JaxService.from_config(SMOKE, edges=_edges(), wait_timeout=WAIT)
    assert (ours.update_batch, ours._queue.maxsize, len(ours._engines)) == \
        (theirs.update_batch, theirs._queue.maxsize, len(theirs._engines))
    events = _stream(ours, 8, 6, seed=SEED + 1)
    rng = np.random.default_rng(1)
    with ours, theirs:
        so, st = ours.session(), theirs.session()
        for lo in range(0, len(events), 5):
            to = so.submit(events[lo:lo + 5])
            tt = st.submit(events[lo:lo + 5])
            assert to == tt
            s, t = rng.integers(0, N, 40), rng.integers(0, N, 40)
            got, want = so.reader()(s, t), st.reader()(s, t)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            ours.drain()
            theirs.drain()
            assert ours.ticket_version(to) == theirs.ticket_version(tt)
            assert ours.version == theirs.version
            _assert_state_equal(ours.state_dict(), theirs.state_dict())
        pinned, ref_pinned = ours.reader(), theirs.reader()
        at = ours.reader(at_version=ours.version, timeout=1.0)
        s, t = rng.integers(0, N, 64), rng.integers(0, N, 64)
        for reader in (pinned, at):
            d, c = reader(s, t)
            dw, cw = ref_pinned(s, t)
            np.testing.assert_array_equal(d.numpy(), np.asarray(dw))
            np.testing.assert_array_equal(c.numpy(), np.asarray(cw))
        _assert_oracle(ours, d, c, s[:16], t[:16])
        assert ours.query_pair(int(s[0]), int(t[0])) == \
            theirs.query_pair(int(s[0]), int(t[0]))
    assert CONSISTENCY_LEVELS == ("pinned", "read_your_writes")
    assert ROLES == ("updater", "replica")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpointed_state_restores_across_packages(writer, tmp_path):
    """A state checkpoint written by either package restores the other
    package's service byte for byte, and both serve the same answers."""
    with _service(update_batch=4) as svc:
        svc.submit(_stream(svc, 4, 2, seed=10))
        svc.drain()
        state = svc.state_dict()
        d = str(tmp_path)
        if writer == "jax":
            JC.save(d, 3, state)
            restored = SPCService.from_checkpoint(d, N, device="cpu")
            _assert_state_equal(restored.state_dict(), state)
        else:
            C.save(d, 3, state)
            restored = JaxService.from_checkpoint(d, N)
            _assert_state_equal(restored.state_dict(), state)
        s = np.arange(N).repeat(2)[:96]
        t = np.arange(N)[::-1].repeat(2)[:96]
        for a, b in zip(svc.query_batch(s, t), restored.query_batch(s, t)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert restored.version == svc.version == 2
        restored.close()
        again = SPCService.from_state_dict(N, state, device="cpu")
        _assert_state_equal(again.state_dict(), state)
        again.close()


def test_distributed_options_name_the_distributed_slice():
    """``mesh=`` (the updater edge-sharded) and ``serve_mesh=`` (snapshots
    staged over the serving mesh) leave the state and the answers of the
    single-device service; ``route="sharded"`` needs a serving mesh, as
    the reference's does."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    plain = _service()
    want = plain.state_dict()
    s, t = np.arange(N), np.arange(N)[::-1].copy()
    d0, c0 = plain.query_batch(s, t)
    for kw in ({"mesh": mesh}, {"serve_mesh": mesh}):
        svc = _service(**kw)
        _assert_state_equal(svc.state_dict(), want)
        d, c = svc.query_batch(s, t)
        np.testing.assert_array_equal(d.numpy(), d0.numpy())
        np.testing.assert_array_equal(c.numpy(), c0.numpy())
    with pytest.raises(ValueError, match="serve_mesh"):
        _service(route="sharded")
    svc = SPCService.from_config(SMOKE, edges=_edges(), mesh=mesh,
                                 serve_mesh=mesh, route="sharded",
                                 device="cpu")
    _assert_state_equal(svc.state_dict(), want)
    d, c = svc.query_batch(s, t)
    np.testing.assert_array_equal(d.numpy(), d0.numpy())
    np.testing.assert_array_equal(c.numpy(), c0.numpy())
    assert svc.stats()["serve"][0].routes == {"sharded[data]:merge": 1}


# -- consistency contract -----------------------------------------------------
def test_read_your_writes_under_concurrent_writer():
    with _service(update_batch=3) as svc:
        events = _stream(svc, 10, 5, seed=3)
        stop = threading.Event()

        def writer():
            for lo in range(0, len(events), 3):
                svc.submit(events[lo:lo + 3])
            stop.set()

        th = threading.Thread(target=writer)
        rw = svc.reader("read_your_writes")
        th.start()
        checked = 0
        while not (stop.is_set() and svc.pending == 0):
            want = svc.accepted
            d, _ = rw([0, 1], [2, 3])
            assert d.shape == (2,) and svc.applied >= want
            if want != NO_TICKET:
                assert rw.last_version >= svc.ticket_version(want)
                checked += 1
        th.join(timeout=WAIT)
        svc.drain()
        assert checked > 0
        assert svc.applied == svc.accepted == -(-len(events) // 3)


def test_pinned_never_waits_and_rw_times_out():
    svc = _service()                     # not started: ingest stalled
    ticket = svc.submit(_stream(svc, 2, 1, seed=4))
    pinned = svc.reader()
    pinned([0, 1], [2, 3])
    assert pinned.last_version == 0 and svc.pending == 1
    with pytest.raises(TimeoutError, match="ticket"):
        svc.reader("read_your_writes", timeout=0.2)([0], [1])
    svc.start()
    svc.drain()
    rw = svc.reader("read_your_writes")
    rw([0], [1])
    assert rw.last_version >= svc.ticket_version(ticket) >= 1
    svc.close()


def test_at_version_reader_blocks_until_published():
    with _service(update_batch=2) as svc:
        late = svc.reader(at_version=svc.version + 3, timeout=WAIT)
        svc.submit(_stream(svc, 4, 2, seed=5))   # 3 committed versions
        late([0], [1])
        assert late.last_version >= 3
        seed_reader = svc.reader(at_version=0, timeout=2)
        seed_reader([0], [1])
        with pytest.raises(ValueError, match="at_version"):
            svc.reader("read_your_writes", at_version=1)
        with pytest.raises(ValueError, match="consistency"):
            svc.reader("linearizable")


def test_read_your_writes_is_session_scoped():
    svc = _service().start()
    gate = threading.Event()
    orig = svc.spc.apply_events

    def gated(events, **kw):
        assert gate.wait(WAIT)
        return orig(events, **kw)

    svc.spc.apply_events = gated
    try:
        foreign, mine = svc.session(), svc.session()
        ticket = foreign.submit(_stream(svc, 2, 1, seed=20))
        assert ticket == 1 and svc.applied == 0
        d, _ = svc.reader("read_your_writes", session=mine,
                          timeout=0.5)([0], [1])
        assert d.shape == (1,)
        rw_foreign = foreign.reader(timeout=0.2)
        with pytest.raises(TimeoutError, match="ticket"):
            rw_foreign([0], [1])
    finally:
        gate.set()
    svc.drain()
    rw_foreign([0], [1])
    assert rw_foreign.last_version >= svc.ticket_version(ticket) >= 1
    foreign.wait_applied(timeout=WAIT)
    assert mine.submit([]) == NO_TICKET and mine.last_ticket == NO_TICKET
    assert svc.ticket_version(NO_TICKET) is None
    svc.close()


# -- ingest lifecycle ---------------------------------------------------------
def test_bounded_queue_backpressure_and_admission_timeout():
    svc = _service(queue_size=1)         # not started: nothing drains
    events = _stream(svc, 4, 2, seed=7)
    assert svc.submit(events[:2]) == 1
    with pytest.raises(queue_lib.Full):
        svc.submit(events[2:4], timeout=0.05)
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(events[2:4])
    with pytest.raises(RuntimeError, match="not started"):
        svc.drain()
    with pytest.raises(RuntimeError, match="not started"):
        svc.close()                      # pending tickets refuse close
    assert svc._submit_lock.acquire()    # another submitter, parked
    try:
        t0 = time.monotonic()
        with pytest.raises(queue_lib.Full, match="admission"):
            svc.submit(events[2:4], timeout=0.05)
        assert time.monotonic() - t0 < 5.0
    finally:
        svc._submit_lock.release()
    svc.start()
    svc.drain()
    t2 = svc.submit(events[2:4])
    svc.drain()
    assert (svc.applied, svc.accepted) == (t2, t2) == (2, 2)
    with svc._cond:                      # the transient inversion window
        svc._applied = svc._accepted + 1
    assert svc.pending == 0 and svc.stats()["ingest"]["pending"] == 0
    with svc._cond:
        svc._applied = svc._accepted
    svc.close()
    svc.close()                          # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit([("+", 0, 1)])
    with pytest.raises(RuntimeError, match="closed"):
        svc.start()
    svc.reader()([0], [1])               # reads outlive the lifecycle


def test_updater_failure_surfaces_everywhere():
    svc = _service(queue_size=1).start()
    present = sorted(edge_set(svc.spc.graph))
    svc.submit([("+",) + present[0]])    # already present: fails at apply
    with pytest.raises(UpdaterError) as ei:
        svc.drain()
    assert isinstance(ei.value.__cause__, ValueError)
    with pytest.raises(UpdaterError):
        svc.submit([("-",) + present[0]])
    with pytest.raises(UpdaterError):
        svc.reader()([0], [1])
    with pytest.raises(UpdaterError):
        svc.raise_if_failed()
    with pytest.raises(UpdaterError):
        svc.close()
    svc2 = _service()
    with pytest.raises(ValueError, match="unknown event op"):
        svc2.submit([("insert", 0, 1)])
    assert svc2.pending == 0


def test_submitter_parked_on_full_queue_wakes_on_updater_death():
    svc = _service(queue_size=1).start()
    present = edge_set(svc.spc.graph)
    absent = next((a, b) for a in range(N) for b in range(a + 1, N)
                  if (a, b) not in present)
    outcome = []

    def feeder():
        try:
            for _ in range(50):          # applies once, dies on repeat
                svc.submit([("+",) + absent])
        except UpdaterError as e:
            outcome.append(e)

    th = threading.Thread(target=feeder)
    th.start()
    th.join(timeout=WAIT)
    assert not th.is_alive()
    assert outcome and isinstance(outcome[0].__cause__, ValueError)


def test_ticket_history_is_bounded():
    with _service(update_batch=2) as svc:
        svc.TICKET_HISTORY = 2
        tickets = [svc.submit([ev]) for ev in _stream(svc, 4, 2, seed=12)]
        svc.drain()
        assert len(svc._ticket_versions) == 2
        assert svc.ticket_version(tickets[0]) is None
        assert svc.ticket_version(tickets[-1]) == svc.version


def test_close_detects_stuck_updater_thread():
    svc = _service(wait_timeout=0.3).start()
    gate = threading.Event()
    orig = svc.spc.apply_events

    def stuck(events, **kw):
        assert gate.wait(WAIT)
        return orig(events, **kw)

    svc.spc.apply_events = stuck
    svc.submit(_stream(svc, 2, 1, seed=22))
    with pytest.raises(TimeoutError, match="updater thread"):
        svc.close(timeout=0.1)
    assert svc._closed
    gate.set()
    svc._thread.join(timeout=WAIT)
    assert not svc._thread.is_alive()


# -- readers, engines, stats --------------------------------------------------
def test_default_reader_built_once_under_race():
    with _service(replicas=2) as svc:
        builds = []
        barrier = threading.Barrier(4)
        orig = svc.reader

        def slow_reader(*a, **kw):
            builds.append(threading.get_ident())
            time.sleep(0.05)
            return orig(*a, **kw)

        svc.reader = slow_reader
        errs = []

        def caller():
            barrier.wait(timeout=WAIT)
            try:
                svc.query_batch([0], [1])
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=caller) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not errs and len(builds) == 1 and svc._rr == 1


def test_replicas_round_robin_and_policy_engines():
    """Shared replicas round-robin; a reader whose policy differs from
    the service's gets a dedicated engine, one per policy (the port
    keys them by policy, the reference by its Pallas knobs)."""
    with _service(replicas=2) as svc:
        r1, r2, r3 = svc.reader(), svc.reader(), svc.reader()
        assert r1.engine is not r2.engine and r3.engine is r1.engine
        r1([0], [1])
        r2([0, 1], [2, 3])
        merge = [svc.reader(route="merge") for _ in range(3)]
        assert merge[0].engine is merge[1].engine is merge[2].engine
        assert merge[0].engine.route == "merge"
        assert svc.reader(route={"kind": "merge"}).engine is merge[0].engine
        assert svc.reader(route="auto").engine in svc._engines
        assert len(svc._engines) == 2 and len(svc._dedicated) == 1
        kern = svc.reader(route="pallas")      # the reference's name
        assert kern.policy == RoutePolicy("kernel")
        d, c = kern([0, 5], [3, 9])
        merge[0]([0], [1])
        st = svc.stats()
        assert [v.queries for v in st["serve"][:2]] == [1, 2]
        assert st["queries"] == 6 and len(st["serve"]) == 4
        assert dict(st["serve"][0].versions) == {0: 1}
        assert st["ingest"]["pending"] == 0 and st["version"] == 0
        assert st["role"] == "updater" and st["replica"] is None
        assert dict(st["serve"][3].routes) == {"kernel": 1}


def test_stats_snapshots_are_frozen_copies():
    stats = ServeStats()
    stats.count("merge", 5)
    stats.count_version(2, 5)
    view = stats.snapshot()
    with pytest.raises(dataclasses.FrozenInstanceError):
        view.queries = 0
    with pytest.raises(TypeError):
        view.versions[2] = 99
    stats.count_version(2, 1)
    assert view.versions[2] == 5 and stats.snapshot().versions[2] == 6


def test_serve_from_pins_and_counts_versions():
    svc = _service()
    store = svc.store
    eng = svc._engines[0]
    serve = eng.serve_from(store)
    d, c = serve([0, 1], [2, 3])
    assert dict(eng.stats.snapshot().versions) == {0: 2}
    sharded = eng.serve_from(store, mesh=make_mesh(
        (2,), ("data",), ["cpu"] * 2))
    for a, b in zip(sharded([0, 1], [2, 3]), (d, c)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert dict(eng.stats.snapshot().versions) == {0: 4}
    svc.start()
    svc.submit(_stream(svc, 2, 1, seed=9))
    svc.drain()
    serve([0], [1], route="merge")
    assert dict(eng.stats.snapshot().versions) == {0: 4, 1: 1}
    svc.close()


def test_analytics_reads_the_services_snapshots():
    with _service() as svc:
        ana = svc.analytics(pair_sample=16, top_k=4)
        assert ana.store is svc.store
        view = ana.pin()
        assert view.version == svc.version and view.n == N
        assert len(ana.top_betweenness()) == 4


def test_chip_smoke_service_phases_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s S1-S4 at the SMOKE size on the CPU, with the
    replica process on the CPU too: every check of the phases holds, the
    front door coalesces, the restart is byte-identical and the replica
    follows it without a ``skipped_behind``; the directory is gone
    afterwards."""
    import tempfile

    import chip_smoke
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.kernels import common
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "FLEET_DISK_BYTES", 1)
    monkeypatch.setattr(chip_smoke, "SERVICE_BATCHES", 4)
    monkeypatch.setattr(chip_smoke, "FD_REQUESTS", 24)
    spc = DynamicSPC(N, _edges(), l_cap=SMOKE.l_cap, device="cpu")
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in ("spc_query", "segment_matmul",
                                              "embedding_bag",
                                              "flash_decode")})
    out = chip_smoke.service_phases(spc, counts, 0, "the CPU", device="cpu")
    assert out["versions"] == [1, 2] and len(out["submit_to_applied_s"]) == 2
    assert out["reader_routes"] == {"merge": out["reader_routes"]["merge"]}
    fd = out["frontdoor"]
    assert fd["requests"] == 8 * 24 and fd["mean_fill"] > 1
    assert out["replica_pull"]["version"] == 3
    assert out["restart"]["version"] == 4
    assert out["restart"]["replica"]["skipped_behind"] == 0
    assert spc.version == 3           # the restored updater owns v4
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith("chip_smoke_fleet_")]
