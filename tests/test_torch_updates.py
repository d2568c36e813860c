"""Parity of the port's update engines and ``DynamicSPC`` driver with the
JAX reference: the same graph and the same mixed event stream go through
``repro.core.dynamic.DynamicSPC`` and ``repro_torch.core.dynamic
.DynamicSPC`` on the CPU, and the port's ``state_dict()`` must be
byte-identical to the reference's after the build and after every event
chunk (and on the per-event path), including label regrowth."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decremental import dec_spc_batch as jax_dec_batch
from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.core.incremental import inc_spc_batch as jax_inc_batch
from repro_torch.core import hybrid as TH
from repro_torch.core.decremental import dec_spc_batch
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.incremental import inc_spc_batch
from repro_torch.data import graph_stream, random_graph_edges

N = 32
EDGES = random_graph_edges(N, 70, seed=21)
# vertex 23 has one edge, which the stream leaves alone; deleting it at
# the end isolates 23 (the Section 3.2.3 fast path)
STREAM = (graph_stream(EDGES, N, 14, 14, seed=22)
          + [("-",) + next(e for e in EDGES if 23 in e)])


def jax_state(svc):
    return {k: np.asarray(v) for k, v in svc.state_dict().items()}


def same_stats(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def assert_state_equal(want, got, what=""):
    assert sorted(want) == sorted(got), what
    for k in want:
        assert want[k].dtype == got[k].dtype, (what, k)
        assert want[k].shape == got[k].shape, (what, k)
        assert want[k].tobytes() == got[k].tobytes(), (what, k)


@pytest.fixture(scope="module")
def jax_chunked():
    """Reference states after the build and after every chunk of 8."""
    out = {}
    for order in ("id", "degree"):
        svc = JaxDSPC(N, EDGES, l_cap=4, vertex_order=order)
        states = [jax_state(svc)]
        for lo in range(0, len(STREAM), 8):
            svc.apply_events(STREAM[lo:lo + 8], batch_size=8)
            states.append(jax_state(svc))
        out[order] = (states, svc.stats.snapshot())
    return out


@pytest.mark.parametrize("order", ["id", "degree"])
def test_chunked_stream_state_identical(jax_chunked, order):
    states, jstats = jax_chunked[order]
    svc = DynamicSPC(N, EDGES, l_cap=4, vertex_order=order, device="cpu")
    assert_state_equal(states[0], svc.state_dict(), "build")
    for k, lo in enumerate(range(0, len(STREAM), 8)):
        svc.apply_events(STREAM[lo:lo + 8], batch_size=8)
        assert_state_equal(states[k + 1], svc.state_dict(), f"chunk {k}")
    assert same_stats(svc.stats.snapshot(), jstats)
    assert svc.stats.label_regrows > 0 and svc.version == len(states) - 1


def test_per_event_path_state_identical():
    ev = STREAM[:11] + STREAM[-1:]
    j = JaxDSPC(N, EDGES, l_cap=8)
    t = DynamicSPC(N, EDGES, l_cap=8, device="cpu")
    for lo in range(0, len(ev), 4):
        j.apply_events(ev[lo:lo + 4], batch_size=None)
        t.apply_events(ev[lo:lo + 4], batch_size=None)
        assert_state_equal(jax_state(j), t.state_dict(), f"events {lo}")
    assert same_stats(t.stats.snapshot(), j.stats.snapshot())
    assert t.stats.isolated_fast_path == 1


def test_insert_edges_vertex_ops_identical():
    j = JaxDSPC(N, EDGES, l_cap=8, construct_batch=4)
    t = DynamicSPC(N, EDGES, l_cap=8, construct_batch=4, device="cpu")
    assert_state_equal(jax_state(j), t.state_dict(), "build")
    new = [(0, 31), (5, 29), (2, 27)]
    new = [e for e in new if e not in set(EDGES)]
    j.insert_edges(new)
    t.insert_edges(new)
    assert_state_equal(jax_state(j), t.state_dict(), "insert_edges")
    assert j.insert_vertex() == t.insert_vertex() == N
    j.insert_edge(N, 3)
    t.insert_edge(N, 3)
    assert_state_equal(jax_state(j), t.state_dict(), "new vertex")
    j.delete_vertex(5, batch_size=4)
    t.delete_vertex(5, batch_size=4)
    assert_state_equal(jax_state(j), t.state_dict(), "delete_vertex")
    j.delete_edge(N, 3)
    t.delete_edge(N, 3)
    assert_state_equal(jax_state(j), t.state_dict(), "isolate new vertex")
    assert same_stats(t.stats.snapshot(), j.stats.snapshot())
    t.rebuild()
    assert t.version == j.version + 1


def test_batch_engines_match_reference():
    """inc_spc_batch / dec_spc_batch (rows with a == b are padding)
    called directly on the same (graph, index) in both packages."""
    j = JaxDSPC(N, EDGES, l_cap=32)
    t = DynamicSPC(N, EDGES, l_cap=32, device="cpu")
    ins = np.asarray([[0, 31], [3, 3], [5, 29]], np.int32)
    dels = np.asarray([list(EDGES[4]), [7, 7], list(EDGES[9])], np.int32)
    jg, ji = jax_inc_batch(j.graph, j.index, jnp.asarray(ins))
    tg, ti = inc_spc_batch(t.graph, t.index, ins)
    jg, ji = jax_dec_batch(jg, ji, jnp.asarray(dels))
    tg, ti = dec_spc_batch(tg, ti, dels)
    for a, b in ((jg.src, tg.src), (jg.dst, tg.dst), (ji.hub, ti.hub),
                 (ji.dist, ti.dist), (ji.cnt, ti.cnt), (ji.size, ti.size),
                 (ji.cnt_sum, ti.cnt_sum), (ji.overflow, ti.overflow)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jg.m2) == tg.m2


def test_hybrid_engine_skips_padding_and_unknown_ops():
    t = DynamicSPC(N, EDGES, l_cap=16, device="cpu")
    g, idx = t.graph, t.index
    events = np.asarray([[0, 0, 0], [TH.OP_INSERT, 4, 4], [7, 1, 2],
                         [TH.OP_DELETE, 9, 9]], np.int32)
    g2, idx2 = TH.hyb_spc_batch(g, idx, events)
    assert g2 is g and idx2 is idx


def test_event_validation_errors():
    t = DynamicSPC(N, EDGES, l_cap=16, device="cpu")
    a, b = EDGES[0]
    cases = [
        ([("*", 0, 1)], "unknown event op"),
        ([(3, 0, 1)], "unknown event op"),
        ([("+", 0)], "triple"),
        ([("+", "x", 1)], "non-integer"),
        ([("+", 2, 2)], "self loop"),
        ([("+", 0, N)], "out of range"),
        ([("+", a, b)], "already present"),
        ([("-", a, b), ("-", b, a)], "not present"),
    ]
    before = t.state_dict()
    for events, msg in cases:
        with pytest.raises(ValueError, match=msg):
            t.apply_events(events)
    assert_state_equal(before, t.state_dict(), "rejected streams")
    with pytest.raises(ValueError, match="already present"):
        t.insert_edge(a, b)
    absent = next((u, v) for u in range(N) for v in range(u + 1, N)
                  if (u, v) not in set(EDGES))
    with pytest.raises(ValueError, match="not present"):
        t.delete_edge(*absent)
    with pytest.raises(ValueError, match="out of range"):
        t.delete_vertex(N)


def test_default_device_is_the_card(monkeypatch):
    """No silent CPU path: without CUDA, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicSPC(4, [(0, 1)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicSPC.from_state_dict(
            4, DynamicSPC(4, [(0, 1)], device="cpu").state_dict())
