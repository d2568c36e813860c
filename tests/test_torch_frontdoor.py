"""The port's front door (``repro_torch.serve.frontdoor``) against the
JAX package's at the ``SMOKE`` configuration (n 64): coalesced
per-request answers equal the JAX front door's and a direct reader's
at the version each request pinned, concurrent callers coalesce (mean
fill > 1), and the reference's contract as
``tests/serve/test_frontdoor.py`` checks it -- per-session
read-your-writes, ``Overloaded``, ``DeadlineExceeded`` removal before
dispatch, ``UpdaterError`` for parked callers, validation and the
lifecycle.  Runs under the runtime shadow lock checker; every join and
wait is bounded."""

import threading
import time

import numpy as np
import pytest

from repro.serve import SPCService as JaxService
from repro_torch.configs.dspc import SMOKE
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.graph import edge_set
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.serve import (NO_TICKET, DeadlineExceeded, FrontDoor,
                               FrontDoorError, Overloaded, SPCService,
                               UpdaterError)

N, M, SEED = SMOKE.n, SMOKE.m, 3
WAIT = 20.0


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _edges():
    return random_graph_edges(N, M, seed=SEED)


def _service(**kw):
    kw.setdefault("l_cap", SMOKE.l_cap)
    kw.setdefault("update_batch", 4)
    kw.setdefault("wait_timeout", WAIT)
    return SPCService(N, _edges(), device="cpu", **kw)


def _stream(svc, n_ins, n_del, seed):
    return graph_stream(sorted(edge_set(svc.spc.graph)), N, n_ins, n_del,
                        seed=seed)


def _gate_updater(svc):
    gate = threading.Event()
    orig = svc.spc.apply_events

    def gated(events, **kw):
        assert gate.wait(WAIT)
        return orig(events, **kw)

    svc.spc.apply_events = gated
    return gate


def _wait_until(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "condition never reached"
        time.sleep(0.005)


def _join(threads):
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive()


def test_coalesced_answers_equal_the_reference_front_door():
    """Eight closed-loop callers on each package's front door over the
    same graph and writes: every request's answer equals the JAX front
    door's, a direct reader's at the version it pinned, and BFS."""
    ours = SPCService.from_config(SMOKE, edges=_edges(), device="cpu",
                                  wait_timeout=WAIT)
    theirs = JaxService.from_config(SMOKE, edges=_edges(), wait_timeout=WAIT)
    events = _stream(ours, 4, 2, seed=SEED + 1)
    with ours, theirs:
        ours.submit(events)
        theirs.submit(events)
        ours.drain()
        theirs.drain()
        direct = ours.reader()
        d_all, c_all = direct(np.repeat(np.arange(N), N),
                              np.tile(np.arange(N), N))
        d_all = d_all.numpy().reshape(N, N)
        c_all = c_all.numpy().reshape(N, N)
        for s in (0, N // 2):
            res = plain_spc_bfs(ours.spc.graph, s)
            np.testing.assert_array_equal(d_all[s], res.dist[:N].numpy())
            np.testing.assert_array_equal(c_all[s], res.cnt[:N].numpy())
        knobs = dict(dispatchers=SMOKE.dispatchers, max_batch=16,
                     max_live_batches=4, deadline_s=WAIT)
        with ours.frontdoor(**knobs) as door, \
                theirs.frontdoor(**knobs) as ref_door:
            failures = []

            def caller(i):
                rng = np.random.default_rng(100 + i)
                mine, ref = door.session(), ref_door.session()
                try:
                    for _ in range(24):
                        k = int(rng.integers(1, 4))
                        s, t = rng.integers(0, N, k), rng.integers(0, N, k)
                        d, c = mine.query_batch(s, t)
                        dw, cw = ref.query_batch(s, t)
                        np.testing.assert_array_equal(d, np.asarray(dw))
                        np.testing.assert_array_equal(c, np.asarray(cw))
                        np.testing.assert_array_equal(d, d_all[s, t])
                        np.testing.assert_array_equal(c, c_all[s, t])
                except BaseException as e:
                    failures.append(e)

            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            _join(threads)
            assert not failures, failures
            st = door.stats()
            assert st["requests"] == 8 * 24
            assert st["queued"] == 0 and st["live"] == 0
            assert st["batches"] <= st["requests"]


def test_concurrent_callers_coalesce_into_one_batch():
    svc = _service().start()
    gate = threading.Event()
    orig_reader = svc.reader

    def gated_reader(*a, **kw):
        inner = orig_reader(*a, **kw)

        def serve(s, t):
            assert gate.wait(WAIT)
            out = inner(s, t)
            serve.last_version = inner.last_version
            return out

        serve.last_version = None
        return serve

    svc.reader = gated_reader
    door = FrontDoor(svc, max_live_batches=2, dispatchers=1,
                     max_batch=16).start()
    results = []

    def caller(i):
        results.append((i, door.session().query(i % N, (i * 3) % N)))

    first = threading.Thread(target=caller, args=(0,))
    first.start()
    _wait_until(lambda: door.stats()["live"] == 1)
    rest = [threading.Thread(target=caller, args=(i,)) for i in range(1, 6)]
    for th in rest:
        th.start()
    _wait_until(lambda: door.stats()["queued"] == 5)
    assert door.stats()["batches"] == 1
    gate.set()
    _join([first] + rest)
    st = door.stats()
    assert st["batches"] == 2 and st["max_fill"] == 5
    assert st["mean_fill"] == 3.0 > 1
    truth = svc.reader()
    for i, (d, c) in results:
        dw, cw = truth([i % N], [(i * 3) % N])
        assert (d, c) == (int(dw[0]), int(cw[0]))
    door.close()
    svc.close()


def test_session_ryw_sees_own_write_and_is_not_gated_by_foreign():
    with _service() as svc:
        with svc.frontdoor() as door:
            sess = door.session("read_your_writes")
            for _ in range(3):
                present = edge_set(svc.spc.graph)
                d_now = svc.reader()
                a, b = next((a, b) for a in range(N) for b in range(a + 1, N)
                            if (a, b) not in present
                            and int(d_now([a], [b])[0][0]) >= 2)
                ticket = sess.submit([("+", a, b)])
                assert ticket > NO_TICKET
                assert sess.query(a, b) == (1, 1)
                assert svc.applied >= ticket
    svc = _service().start()
    gate = _gate_updater(svc)
    try:
        with FrontDoor(svc, deadline_s=2.0) as door:
            foreign = door.session("read_your_writes")
            mine = door.session("read_your_writes")
            assert foreign.submit(_stream(svc, 2, 1, seed=SEED + 2)) == 1
            t0 = time.monotonic()
            mine.query(0, 1)                       # no own write: no wait
            assert time.monotonic() - t0 < 1.5
            with pytest.raises(DeadlineExceeded):
                foreign.query(0, 1, deadline=0.3)
            _wait_until(lambda: door.stats()["expired"] == 1)
    finally:
        gate.set()
    svc.close()


def test_deadline_expired_removed_from_batch_before_dispatch():
    svc = _service().start()
    gate = _gate_updater(svc)
    try:
        with FrontDoor(svc) as door:
            rw = door.session("read_your_writes")
            rw.submit(_stream(svc, 2, 1, seed=SEED + 3))
            with pytest.raises(DeadlineExceeded):
                rw.query(0, 1, deadline=0.2)
            _wait_until(lambda: door.stats()["expired"] == 1)
            assert door.stats()["batches"] == 0
            assert door.session().query(0, 1)
            st = door.stats()
            assert st["batches"] == 1 and st["pairs"] == 1
    finally:
        gate.set()
    svc.close()


def test_admission_rejects_overloaded_with_typed_error():
    svc = _service().start()
    gate = _gate_updater(svc)
    door = FrontDoor(svc, max_live_batches=1, max_batch=4,
                     deadline_s=WAIT).start()
    assert door.max_queued == 4
    rw = door.session("read_your_writes")
    rw.submit(_stream(svc, 2, 1, seed=SEED + 4))
    answers, threads = [], []
    for i in range(4):
        th = threading.Thread(
            target=lambda i=i: answers.append(rw.query(i, (i + 5) % N)))
        th.start()
        threads.append(th)
    _wait_until(lambda: door.stats()["queued"] == 4)
    t0 = time.monotonic()
    with pytest.raises(Overloaded, match="bound"):
        rw.query(0, 1)
    assert time.monotonic() - t0 < 1.0
    assert door.stats()["rejected"] == 1
    gate.set()
    _join(threads)
    assert len(answers) == 4
    door.close()
    svc.close()


def test_updater_death_propagates_to_parked_callers():
    svc = _service().start()
    with FrontDoor(svc, deadline_s=WAIT) as door:
        sess = door.session("read_your_writes")
        present = sorted(edge_set(svc.spc.graph))
        sess.submit([("+",) + present[0]])
        with pytest.raises(UpdaterError) as ei:
            sess.query(0, 1)
        assert isinstance(ei.value.__cause__, ValueError)
        with pytest.raises(UpdaterError):
            door.session().query(0, 1)
    with pytest.raises(UpdaterError):
        svc.close()


def test_validation_lifecycle_and_orphans():
    with _service() as svc:
        with svc.frontdoor(max_batch=8) as door:
            sess = door.session()
            with pytest.raises(ValueError, match="out of range"):
                sess.query(0, N + 7)
            with pytest.raises(ValueError, match="mismatch"):
                sess.query_batch([0, 1], [2])
            with pytest.raises(ValueError, match="max_batch"):
                sess.query_batch(np.zeros(9, np.int32),
                                 np.zeros(9, np.int32))
            with pytest.raises(ValueError, match="consistency"):
                door.session("linearizable")
            d, c = sess.query_batch([], [])
            assert d.shape == (0,) and c.shape == (0,)
            assert door.stats()["requests"] == 0
    svc = _service().start()
    door = FrontDoor(svc)
    with pytest.raises(RuntimeError, match="not started"):
        door.session().query(0, 1)
    gate = _gate_updater(svc)
    door.start()
    rw = door.session("read_your_writes")
    rw.submit(_stream(svc, 2, 1, seed=SEED + 5))
    errs = []

    def parked():
        try:
            rw.query(0, 1)
        except BaseException as e:
            errs.append(e)

    th = threading.Thread(target=parked)
    th.start()
    _wait_until(lambda: door.stats()["queued"] == 1)
    door.close()
    _join([th])
    assert len(errs) == 1 and isinstance(errs[0], FrontDoorError)
    door.close()
    with pytest.raises(RuntimeError, match="closed"):
        door.start()
    gate.set()
    svc.close()


def test_from_config_builds_and_owns_the_stack():
    door = FrontDoor.from_config(SMOKE, device="cpu")
    assert (door.max_live_batches, door.dispatchers, door.max_batch,
            door.deadline_s) == (SMOKE.max_live_batches, SMOKE.dispatchers,
                                 SMOKE.frontdoor_batch, SMOKE.deadline_s)
    door.service.start()
    with door:
        sess = door.session("read_your_writes")
        assert sess.submit([]) == NO_TICKET
        d, c = sess.query(0, 1)
        assert isinstance(d, int) and isinstance(c, int)
    assert door.service._closed
    with _service() as svc:
        door2 = FrontDoor.from_config(SMOKE, service=svc, max_live_batches=8)
        assert door2.max_live_batches == 8
        with door2:
            door2.session().query(0, 1)
        assert not svc._closed
