"""Parity of the port's serving engine with the JAX reference, and state
carried across the two packages.

Every route of ``repro_torch.serve.QueryEngine`` (merge, table, and the
kernel route, which on the CPU is the kernel's plain version) answers
all pairs of a lived-in index exactly as the reference's routes do
(its Pallas route in interpret mode) and as the port's BFS oracle does.
The engine's validation errors, empty batches and bucket statistics
follow ``tests/serve/test_engine.py``.  A reference ``state_dict()``
loads into the port and the reverse, with identical answers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.serve import QueryEngine as JaxEngine
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import random_graph_edges
from repro_torch.serve import (DEFAULT_BUCKETS, QueryEngine, RoutePolicy,
                               ServeStats, bucket_size, coalesce_pairs,
                               split_rows)

N = 40
EDGES = [(a, b) for a, b in random_graph_edges(N, 90, seed=3)
         if max(a, b) < N - 4]
EVENTS = ([("+", 0, 36), ("+", 36, 37), ("+", 38, 39)]
          + [("-",) + EDGES[0], ("-", 36, 37)])
ROUTES = {"merge": "merge", "table": "table", "kernel": "pallas"}


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_state(svc):
    return {k: np.asarray(v) for k, v in svc.state_dict().items()}


def assert_state_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].tobytes() == got[k].tobytes(), k


@pytest.fixture(scope="module")
def services():
    """A service that has lived (inserts, deletes, an isolated vertex,
    a disconnected 2-component), in both packages."""
    j = JaxDSPC(N, EDGES, l_cap=64)
    t = DynamicSPC(N, EDGES, l_cap=64, device="cpu")
    j.apply_events(EVENTS)
    t.apply_events(EVENTS)
    assert_state_equal(jax_state(j), t.state_dict())
    return j, t


@pytest.fixture(scope="module")
def all_pairs():
    s, t = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return s.reshape(-1), t.reshape(-1)


def test_all_pairs_routes_match_reference_and_oracle(services, all_pairs):
    j, t = services
    s, tt = all_pairs
    eng, jeng = QueryEngine(), JaxEngine(interpret=True)
    want_d = np.stack([host(plain_spc_bfs(t.graph, v).dist[:N])
                       for v in range(N)]).reshape(-1)
    want_c = np.stack([host(plain_spc_bfs(t.graph, v).cnt[:N])
                       for v in range(N)]).reshape(-1)
    for route, jroute in ROUTES.items():
        d, c = eng.query_batch(t.index, s, tt, route=route)
        assert d.dtype == torch.int32 and c.dtype == torch.int64
        dj, cj = jeng.query_batch(j.index, s, tt, route=jroute)
        np.testing.assert_array_equal(host(d), host(dj), err_msg=route)
        np.testing.assert_array_equal(host(c), host(cj), err_msg=route)
        np.testing.assert_array_equal(host(d), want_d, err_msg=route)
        np.testing.assert_array_equal(host(c), want_c, err_msg=route)
    # on a CPU index "auto" is the merge route; the kernel route is named
    eng.query_batch(t.index, s[:5], tt[:5])
    assert dict(eng.stats.routes) == {"merge": 2, "table": 1, "kernel": 1}
    assert eng.stats.queries == 3 * N * N + 5


def test_driver_query_paths_agree(services):
    j, t = services
    rng = np.random.default_rng(1)
    s, tt = rng.integers(0, N, 20), rng.integers(0, N, 20)
    d, c = t.query_batch(s, tt)
    dj, cj = j.query_batch(s, tt)
    np.testing.assert_array_equal(host(d), host(dj))
    np.testing.assert_array_equal(host(c), host(cj))
    for k in range(len(s)):
        assert t.query(int(s[k]), int(tt[k])) == (int(d[k]), int(c[k]))
    assert set(t.engine.stats.routes) == {"merge"}


def test_bucket_padding_and_stats(services):
    _, t = services
    assert DEFAULT_BUCKETS == (8, 64, 256, 1024)
    assert [bucket_size(b) for b in (1, 8, 9, 64, 65, 1024, 1025, 5000)] \
        == [8, 8, 64, 64, 256, 1024, 2048, 5120]
    eng = QueryEngine(route="kernel")
    for b in (1, 3, 5, 8):
        d, c = eng.query_batch(t.index, list(range(b)), list(range(b)))
        assert d.shape == (b,) and c.shape == (b,)
        assert [(int(x), int(y)) for x, y in zip(d, c)] == [(0, 1)] * b
    assert eng.stats.batches == 4 and eng.stats.queries == 17
    view = eng.stats.snapshot()
    with pytest.raises(TypeError):
        view.routes["kernel"] = 0  # read-only mapping proxy
    st = ServeStats()
    st.count("merge", 5)
    st.count("merge", 3)
    st.count_version(4, 8)
    assert dataclasses.asdict(st) == {"queries": 8, "batches": 2,
                                      "routes": {"merge": 2},
                                      "versions": {4: 8}}


def test_empty_batch_early_returns(services):
    _, t = services
    eng = QueryEngine()
    for route in (None, "merge", "table", "kernel"):
        d, c = eng.query_batch(t.index, [], [], route=route)
        assert d.shape == (0,) and c.shape == (0,)
        assert d.dtype == torch.int32 and c.dtype == torch.int64
        assert d.device == t.index.device
    assert eng.stats.batches == 0 and eng.stats.queries == 0
    assert eng.stats.routes == {}
    with pytest.raises(ValueError, match="unknown route"):
        eng.query_batch(t.index, [], [], route="bogus")


def test_engine_validation_errors(services):
    _, t = services
    with pytest.raises(ValueError, match="unknown route"):
        QueryEngine(route="bogus")
    # the reference's TPU kernel route names the port's CUDA kernel route
    assert QueryEngine(route="pallas").route == "kernel"
    eng = QueryEngine()
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.query_batch(t.index, [0, 1], [1])
    for bad in ([-1], [N], np.asarray([2 ** 40], np.int64)):
        with pytest.raises(ValueError, match="out of range"):
            eng.query_batch(t.index, bad, [0])
    assert eng.stats.batches == 0


def test_route_policy():
    assert RoutePolicy.coerce(None) == RoutePolicy("auto")
    assert RoutePolicy.coerce("kernel").kind == "kernel"
    p = RoutePolicy("merge")
    assert RoutePolicy.coerce(p) is p and hash(p) == hash(RoutePolicy("merge"))
    assert RoutePolicy.coerce({"kind": "merge"}) == p
    assert RoutePolicy.coerce("pallas") == RoutePolicy("kernel")
    assert not p.needs_mesh and p.engine_route == "merge"
    for bad in ({"kind": "pallas", "block_b": 64}, "bogus", 3):
        with pytest.raises(ValueError):
            RoutePolicy.coerce(bad)
    sh = RoutePolicy.coerce("sharded")
    assert sh == RoutePolicy.sharded(("data",)) and sh.needs_mesh
    assert sh.engine_route == "merge"
    sh = RoutePolicy.coerce({"kind": "sharded", "batch_axes": ["x", "y"]})
    assert sh.batch_axes == ("x", "y") and sh.needs_mesh
    for bad in ({"kind": "sharded"}, {"kind": "merge", "batch_axes": ["x"]}):
        with pytest.raises(ValueError, match="batch_axes|axis names"):
            RoutePolicy.coerce(bad)
    assert QueryEngine(route=RoutePolicy("table")).route == "table"


def test_coalesce_pairs_and_split_rows_round_trip():
    parts = [([0], [1]), ([2, 3, 4], [5, 6, 7]), ([8, 9], [10, 11])]
    s, t, offsets = coalesce_pairs(parts)
    np.testing.assert_array_equal(s, [0, 2, 3, 4, 8, 9])
    np.testing.assert_array_equal(offsets, [0, 1, 4, 6])
    back = split_rows(torch.arange(6, dtype=torch.int32),
                      torch.arange(6, dtype=torch.int64) * 10, offsets)
    np.testing.assert_array_equal(back[1][0], [1, 2, 3])
    np.testing.assert_array_equal(back[2][1], [40, 50])
    big = np.asarray([2 ** 40], np.int64)
    s2, t2, _ = coalesce_pairs([(big, [0])])
    assert s2.dtype == np.int64 and int(s2[0]) == 2 ** 40
    with pytest.raises(ValueError, match="out of range"):
        QueryEngine._validate_ids(100, s2, t2)
    s, t, off = coalesce_pairs([])
    assert s.shape == (0,) and list(off) == [0]
    with pytest.raises(ValueError, match="part 1"):
        coalesce_pairs([([0], [1]), ([0, 1], [2])])
    with pytest.raises(ValueError, match="cover"):
        split_rows(np.zeros(2, np.int32), np.zeros(3, np.int64),
                   np.asarray([0, 3]))


@pytest.mark.parametrize("order", ["id", "degree"])
def test_state_dict_carries_across_packages(order, all_pairs):
    s, tt = all_pairs
    j = JaxDSPC(N, EDGES, l_cap=16, vertex_order=order, construct_batch=8)
    j.apply_events(EVENTS[:3])
    # JAX -> port
    t = DynamicSPC.from_state_dict(N, jax_state(j), device="cpu")
    assert_state_equal(jax_state(j), t.state_dict())
    assert t.version == j.version and t.order.order == j.order.order
    d, c = t.query_batch(s, tt)
    dj, cj = j.query_batch(s, tt)
    np.testing.assert_array_equal(host(d), host(dj))
    np.testing.assert_array_equal(host(c), host(cj))
    # both go on identically, then port -> JAX
    j.apply_events(EVENTS[3:])
    t.apply_events(EVENTS[3:])
    back = JaxDSPC.from_state_dict(N, t.state_dict())
    assert_state_equal(t.state_dict(), jax_state(back))
    dj, cj = back.query_batch(s, tt)
    d, c = t.query_batch(s, tt)
    np.testing.assert_array_equal(host(d), host(dj))
    np.testing.assert_array_equal(host(c), host(cj))


def test_legacy_and_invalid_state_dicts(services):
    _, t = services
    state = t.state_dict()
    legacy = {k: v for k, v in state.items()
              if k not in ("index.cnt_sum", "version")}
    t2 = DynamicSPC.from_state_dict(N, legacy, device="cpu")
    assert t2.version == 0
    np.testing.assert_array_equal(t2.state_dict()["index.cnt_sum"],
                                  state["index.cnt_sum"])
    bad = dict(state)
    bad["index.size"] = state["index.size"][:-1]
    with pytest.raises(ValueError, match="index.size"):
        DynamicSPC.from_state_dict(N, bad, device="cpu")
    bad = dict(state)
    del bad["graph.m2"]
    with pytest.raises(ValueError, match="missing key"):
        DynamicSPC.from_state_dict(N, bad, device="cpu")
    bad = dict(state, **{"order.vertex_of": np.zeros(N, np.int32)})
    with pytest.raises(ValueError, match="permutation"):
        DynamicSPC.from_state_dict(N, bad, device="cpu")
    bad = dict(state, **{"index.cnt": state["index.cnt"].astype(float)})
    with pytest.raises(ValueError, match="non-integer"):
        DynamicSPC.from_state_dict(N, bad, device="cpu")
    assert jnp.asarray(state["version"]).dtype == jnp.int64
