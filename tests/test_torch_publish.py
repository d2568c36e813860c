"""The port's snapshot store, transport and ``attach_store``, with the
semantics of the reference's (``repro.serve.publish`` / ``transport``,
``repro.core.dynamic.attach_store``): monotone versions, the empty
store, publish once per committed chunk (overflow retry included, and
byte-equal to the reference's published states), and the pin surviving
every kind of later update byte for byte.

Torch tensors can be written in place where JAX arrays cannot, so the
pin tests copy every tensor of a pinned snapshot and compare bytes after
the updates.  Runs under the runtime shadow lock checker, as
``tests/serve`` does."""

import dataclasses
import json
import os

import numpy as np
import pytest

from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.data import graph_stream, random_graph_edges
from repro_torch.core import graph as G
from repro_torch.core.distributed import replicas_of
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import edge_set
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import (LocalTransport, PublisherBehindError,
                               QueryEngine, Snapshot, SnapshotGoneError,
                               SnapshotStore)

FIELDS = ("hub", "dist", "cnt", "size", "cnt_sum", "overflow")


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _bytes(idx):
    return {k: getattr(idx, k).numpy().tobytes() for k in FIELDS}


def _jax_bytes(idx):
    return {k: np.asarray(getattr(idx, k)).tobytes()
            for k in FIELDS if k != "overflow"}


@pytest.fixture()
def svc():
    n = 30
    return DynamicSPC(n, random_graph_edges(n, 70, seed=11), l_cap=32,
                      device="cpu")


def test_version_monotonicity(svc):
    store = SnapshotStore(svc.index, version=5)
    assert store.version == 5
    assert store.publish(svc.index) == 6          # default: bump
    assert store.publish(svc.index, version=9) == 9
    for bad in (9, 8, 0, -1):
        with pytest.raises(ValueError, match="monotonically"):
            store.publish(svc.index, version=bad)
    assert store.version == 9                      # failed publishes: no swap
    assert store.publishes == 2
    assert store.transport.poll() == 9


def test_empty_store_raises_until_first_publish(svc):
    store = SnapshotStore()
    assert store.version is None
    with pytest.raises(RuntimeError):
        store.current()
    assert store.publish(svc.index) == 0           # first version is 0
    assert store.current().index is svc.index


def test_snapshot_is_immutable_dataclass(svc):
    snap = Snapshot(3, svc.index)
    with pytest.raises(dataclasses.FrozenInstanceError):
        snap.version = 4


def test_later_slices_options_raise(svc, tmp_path):
    """``mesh=`` stages the seed snapshot over the mesh (one copy per
    distinct device: four ``cpu`` entries share the index itself);
    ``checkpoint_dir=`` publishes into that directory as the reference's
    store does: the same committed steps, manifests and bytes, readable
    by the reference's ``load_snapshot``."""
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    staged = SnapshotStore(svc.index, mesh=mesh).current().index
    assert replicas_of(staged) == {staged.device: staged}
    assert _bytes(staged) == _bytes(svc.index)
    with pytest.raises(ValueError, match="not both"):
        SnapshotStore(svc.index, checkpoint_dir=str(tmp_path / "x"),
                      transport=LocalTransport())
    state = svc.state_dict()
    events = graph_stream(sorted(edge_set(svc.graph)), svc.n, 4, 4, seed=1)
    from repro.serve.transport import load_snapshot as jax_load
    # synchronous writes with keep=2 gc step 0 in both packages; async
    # ones with keep=3 never reach the window, whatever the writes' timing
    for async_checkpoint, keep, steps in ((False, 2, (1, 2)),
                                          (True, 3, (0, 1, 2))):
        ours = tmp_path / f"port-{keep}"
        theirs = tmp_path / f"ref-{keep}"
        port = DynamicSPC.from_state_dict(svc.n, state, device="cpu")
        ref = JaxDSPC.from_state_dict(svc.n, state)
        for spc, path in ((port, ours), (ref, theirs)):
            store = spc.attach_store(checkpoint_dir=str(path),
                                     async_checkpoint=async_checkpoint,
                                     keep=keep)
            spc.apply_events(events, batch_size=4)   # two chunks, two steps
            store.wait()
        want = ["LATEST"] + [f"step_{k:09d}" for k in steps]
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == want
        for step in steps:
            got = jax_load(str(ours), step=step)
            ref_snap = jax_load(str(theirs), step=step)
            assert got.version == ref_snap.version == step
            assert _jax_bytes(got.index) == _jax_bytes(ref_snap.index)
            with open(ours / f"step_{step:09d}" / "manifest.json") as f:
                man = json.load(f)
            with open(theirs / f"step_{step:09d}" / "manifest.json") as f:
                assert json.load(f) == man


def test_local_transport_versions(svc):
    tr = LocalTransport()
    assert tr.poll() is None
    with pytest.raises(FileNotFoundError):
        tr.fetch()
    tr.publish(Snapshot(2, svc.index))
    tr.publish(Snapshot(2, svc.index))            # idempotent re-publish
    with pytest.raises(PublisherBehindError) as err:
        tr.publish(Snapshot(1, svc.index))
    assert (err.value.version, err.value.committed) == (1, 2)
    assert tr.fetch().version == tr.fetch(2).version == 2
    with pytest.raises(SnapshotGoneError):
        tr.fetch(1)
    assert tr.wait_notify(0.01) is False          # nothing new published
    store = SnapshotStore(transport=tr)
    with pytest.raises(PublisherBehindError):     # the medium is ahead
        store.publish(svc.index, version=1)


def test_reader_pinned_while_next_version_is_written(svc):
    """A reader pinned on version k is unaffected, byte for byte, by the
    updater writing and publishing k + 1."""
    store = svc.attach_store()
    eng = QueryEngine()
    rng = np.random.default_rng(0)
    s = rng.integers(0, svc.n, 33)
    t = rng.integers(0, svc.n, 33)
    pinned = store.current()
    want = _bytes(pinned.index)
    d_before, c_before = eng.query_batch(pinned.index, s, t)
    edges = sorted(edge_set(svc.graph))
    svc.apply_events(graph_stream(edges, svc.n, 6, 3, seed=1), batch_size=4)
    assert store.version > pinned.version
    assert _bytes(pinned.index) == want
    d_after, c_after = eng.query_batch(pinned.index, s, t)
    np.testing.assert_array_equal(d_after.numpy(), d_before.numpy())
    np.testing.assert_array_equal(c_after.numpy(), c_before.numpy())
    assert store.current().index is svc.index


def _mutations():
    """Each public mutation of ``DynamicSPC``, as (name, fn(svc))."""
    def events(svc):
        svc.apply_events(graph_stream(sorted(edge_set(svc.graph)), svc.n,
                                      5, 5, seed=3), batch_size=4)

    def per_event(svc):
        svc.apply_events(graph_stream(sorted(edge_set(svc.graph)), svc.n,
                                      2, 2, seed=4), batch_size=None)

    def isolate(svc):        # delete the last edge of a degree-1 vertex
        deg = G.degrees(svc.graph)[:svc.n]
        v = int((deg == 1).nonzero()[0, 0])
        u = int(svc.graph.dst[(svc.graph.src == v).nonzero()[0, 0]])
        svc.delete_edge(u, v)

    return [("apply_events", events), ("per_event", per_event),
            ("isolated_fast_path", isolate),
            ("insert_vertex", lambda svc: svc.insert_vertex()),
            ("rebuild", lambda svc: svc.rebuild())]


@pytest.mark.parametrize("name,mutate", _mutations(),
                         ids=[m[0] for m in _mutations()])
def test_pin_survives_every_update_byte_for_byte(name, mutate):
    n = 24
    edges = random_graph_edges(n, 40, seed=5) + [(0, n - 1)]
    edges = sorted(set((min(a, b), max(a, b)) for a, b in edges))
    svc = DynamicSPC(n, edges, l_cap=None, device="cpu")
    store = svc.attach_store()
    pinned = store.current()
    want = _bytes(pinned.index)
    mutate(svc)
    assert store.version == svc.version > pinned.version
    assert _bytes(pinned.index) == want, name


def test_swap_atomicity_under_overflow_retry():
    """A chunk that overflows and replays publishes exactly once, after
    the retry commits, and never exposes the overflowed index."""
    n = 8
    star = [(0, v) for v in range(1, n)]           # fits exactly at l_cap=2
    events = [("+", 1, 2), ("+", 2, 3), ("-", 0, 4), ("+", 4, 5)]
    svc = DynamicSPC(n, star, l_cap=2, device="cpu")
    seq = DynamicSPC(n, star, l_cap=2, device="cpu")
    store = svc.attach_store()
    pinned = store.current()
    before = _bytes(pinned.index)
    svc.apply_events(events, batch_size=4)         # one chunk, must regrow
    assert svc.stats.label_regrows >= 1
    assert store.publishes == 1                    # retry != extra publish
    assert store.version == pinned.version + 1
    assert _bytes(pinned.index) == before
    front = store.current().index
    assert int(front.overflow) == 0
    seq.apply_events(events, batch_size=None)      # per-event trajectory
    s, t = np.divmod(np.arange(n * n), n)
    eng = QueryEngine()
    for got, want in zip(eng.query_batch(front, s, t),
                         eng.query_batch(seq.index, s, t)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_attach_store_publishes_each_committed_chunk_as_reference():
    n = 40
    edges = random_graph_edges(n, 90, seed=2)
    svc = DynamicSPC(n, edges, l_cap=None, device="cpu")
    ref = JaxDSPC(n, edges, l_cap=None)
    store, ref_store = svc.attach_store(), ref.attach_store()
    assert store.version == ref_store.version == 0
    stream = graph_stream(edges, n, 6, 6, seed=3)
    seen = []
    for lo in range(0, len(stream), 4):
        svc.apply_events(stream[lo:lo + 4], batch_size=4)
        ref.apply_events(stream[lo:lo + 4], batch_size=4)
        snap, ref_snap = store.current(), ref_store.current()
        assert snap.version == ref_snap.version == svc.version
        got = _bytes(snap.index)
        del got["overflow"]
        assert got == _jax_bytes(ref_snap.index)
        seen.append(snap.version)
    assert seen == [1, 2, 3] and store.publishes == 3


def test_attach_store_to_existing_store():
    n = 20
    svc = DynamicSPC(n, random_graph_edges(n, 40, seed=6), device="cpu")
    svc.insert_vertex()
    svc.insert_vertex()                            # DynamicSPC at version 2
    behind = SnapshotStore(svc.index, version=0)
    assert svc.attach_store(behind) is behind
    assert behind.version == 2                     # caught up on attach
    ahead = SnapshotStore(svc.index, version=7)
    with pytest.raises(ValueError, match="ahead"):
        svc.attach_store(ahead)
    empty = SnapshotStore()
    svc.attach_store(empty)
    assert empty.version == 2
