"""The port's analytics layer (``repro_torch.analytics``) against the
reference (``repro.analytics``) on byte-identical snapshots.

The reference builds the index; the port loads the reference's
``state_dict()``, so both analytics layers read the same label bytes.
Then:

* integer results are exactly equal: recommendations, feature rows,
  common-friend ids, neighbourhoods, cycle counts (``CycleCount`` field
  by field), changed rows and sampled pairs;
* pair dependencies / betweenness agree within rtol 1e-12 (float64;
  only the order of the sum over pairs differs);
* ``TopKBetweenness`` over the same published stream: scores within
  rtol 1e-12 and equal refresh counters;
* the port's own oracles agree with the port's results, as in
  ``tests/analytics``.

Runs under the runtime shadow lock checker, as ``tests/analytics``
does."""

import dataclasses
import sys

import numpy as np
import pytest

import repro.analytics  # noqa: F401  (registers the submodules below)
import repro_torch.analytics  # noqa: F401
from repro.configs.dspc import SMOKE as JAX_SMOKE
from repro.core import labels as JL
from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.data import graph_stream, random_graph_edges
from repro.serve.publish import SnapshotStore as JaxStore
from repro_torch.configs.dspc import SMOKE
from repro_torch.core import labels as L
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import INF

jb, jr, jc, je = (sys.modules[f"repro.analytics.{m}"] for m in
                  ("betweenness", "recommend", "cycles", "engine"))
tb, tr, tc, te = (sys.modules[f"repro_torch.analytics.{m}"] for m in
                  ("betweenness", "recommend", "cycles", "engine"))

N = 18
L_CAP = 24


@pytest.fixture(autouse=True)
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


def _port_of(j):
    """A port ``DynamicSPC`` loaded from the reference's state."""
    return DynamicSPC.from_state_dict(
        j.n, {k: np.asarray(v) for k, v in j.state_dict().items()},
        device="cpu")


def _pair(n, edges, l_cap=L_CAP):
    """(reference ``DynamicSPC``, port ``DynamicSPC``) holding
    byte-identical indexes."""
    j = JaxDSPC(n, edges, l_cap=l_cap)
    return j, _port_of(j)


@pytest.fixture(scope="module")
def graphs():
    out = []
    for seed in (0, 1):
        edges = random_graph_edges(N, 40, seed=seed)
        out.append((edges,) + _pair(N, edges))
    return out


# -- recommendation -------------------------------------------------------
def test_recommend_features_and_common_ids_equal(graphs):
    for edges, j, t in graphs:
        everyone = np.arange(N)
        for u in range(N):
            want = jr.recommend(j.index, u, k=5)
            got = tr.recommend(t.index, u, k=5)
            assert [dataclasses.astuple(r) for r in got] == \
                [dataclasses.astuple(r) for r in want], u
            assert [dataclasses.astuple(r) for r in
                    tr.recommend_numpy(N, edges, u, k=5)] == \
                [dataclasses.astuple(r) for r in got], u
            f_want = jr.recommendation_features(j.index, u, everyone)
            f_got = tr.recommendation_features(t.index, u, everyone)
            assert f_got.dtype == np.float32
            assert f_got.tobytes() == f_want.tobytes(), u
        for u, x in ((0, 5), (3, 9), (1, 17), (4, 4)):
            want = jr.common_neighbor_ids(j.index, u, x)
            got = tr.common_neighbor_ids(t.index, u, x)
            np.testing.assert_array_equal(got, want)


def test_recommend_ties_and_disconnected_features():
    # 0 has friends 1, 2; candidates 3 and 4 tie at 2 common friends, 5
    # has one; 6 is disconnected
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (1, 4), (2, 4), (2, 5)]
    j, t = _pair(7, edges, l_cap=12)
    got = tr.recommend(t.index, 0)
    assert [(r.vertex, r.score, r.dist) for r in got] == \
        [(3, 2, 2), (4, 2, 2), (5, 1, 2)]
    assert got == [tr.Recommendation(*dataclasses.astuple(r))
                   for r in jr.recommend(j.index, 0)]
    feats = tr.recommendation_features(t.index, 0, np.asarray([3, 6, 0]))
    assert feats.tobytes() == jr.recommendation_features(
        j.index, 0, np.asarray([3, 6, 0])).tobytes()
    assert feats[1, 0] == -1.0 and feats[1, 1] == 0.0
    assert tr.recommend(t.index, 6) == []


# -- cycles ---------------------------------------------------------------
def test_neighbors_and_vertex_cycles_equal(graphs, monkeypatch):
    monkeypatch.setattr(tc, "ROOT_CHUNK", 4)      # several root chunks
    for edges, j, t in graphs:
        for v in range(N):
            np.testing.assert_array_equal(tc.neighbors(t.index, v),
                                          jc.neighbors(j.index, v))
            got = tc.cycles_through_vertex(t.index, v)
            want = jc.cycles_through_vertex(j.index, v)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), v
            assert got.odd_count == \
                tc.triangles_through_vertex_oracle(N, edges, v)
            assert got.even_count == \
                tc.four_cycles_through_vertex_oracle(N, edges, v)
            length, count = tc.cycles_through_vertex_oracle(N, edges, v)
            if got.certified:
                assert (got.length, got.count) == (length, count), v
            else:
                assert length >= 5, v


def test_edge_cycles_equal(graphs):
    for edges, j, t in graphs:
        for a, b in edges[:10]:
            got = tc.cycles_through_edge(t.index, a, b)
            want = jc.cycles_through_edge(j.index, a, b)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            length, count = tc.cycles_through_edge_oracle(N, edges, a, b)
            if got.certified:
                assert (got.length, got.count) == (length, count)
        with pytest.raises(ValueError, match="not an edge"):
            a = next(x for x in range(1, N)
                     if x not in set(tc.neighbors(t.index, 0).tolist()))
            tc.cycles_through_edge(t.index, 0, a)


def test_girth_beyond_horizon_uncertified():
    n = 6
    edges = [(i, (i + 1) % n) for i in range(n)]
    j, t = _pair(n, edges, l_cap=12)
    for v in range(n):
        got = tc.cycles_through_vertex(t.index, v)
        assert got == tc.CycleCount(int(INF), 0, False, 4, 0, 0)
        assert dataclasses.astuple(got) == \
            dataclasses.astuple(jc.cycles_through_vertex(j.index, v))
        assert tc.cycles_through_vertex_oracle(n, edges, v) == (6, 1)


# -- betweenness ----------------------------------------------------------
def test_betweenness_all_pairs_within_1e12(graphs):
    for edges, j, t in graphs:
        want = jb.betweenness(j.index)
        got = tb.betweenness(t.index)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, tb.betweenness_numpy(N, edges),
                                   rtol=1e-9, atol=1e-9)


def test_dependency_scores_restricted_and_disconnected():
    # two disjoint 4-cliques + a path 8-9-10 + isolated 11
    edges = ([(a, b) for a in range(4) for b in range(a + 1, 4)]
             + [(a, b) for a in range(4, 8) for b in range(a + 1, 8)]
             + [(8, 9), (9, 10)])
    j, t = _pair(12, edges, l_cap=16)
    rng = np.random.default_rng(0)
    s, tt = tb.all_pairs(12)
    keep = rng.choice(s.shape[0], size=40, replace=False)
    verts = np.asarray([0, 3, 9, 11, 5], dtype=np.int32)
    want = jb.dependency_scores(j.index, s[keep], tt[keep], verts)
    got = tb.dependency_scores(t.index, s[keep], tt[keep], verts,
                               v_block=2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    full = tb.betweenness(t.index)
    np.testing.assert_allclose(full, tb.betweenness_numpy(12, edges),
                               rtol=1e-9, atol=1e-9)
    assert full[11] == 0.0 and full[9] == 2.0      # 8 <-> 10 both ways
    assert tb.dependency_scores(t.index, s[:0], tt[:0], verts).tolist() == \
        [0.0] * 5
    with pytest.raises(ValueError):
        tb.dependency_scores(t.index, s[:3], tt[:2], verts)


def test_changed_rows_equal_across_a_chunk():
    n = 24
    edges = random_graph_edges(n, 60, seed=7)
    j, t = _pair(n, edges, l_cap=28)
    before_j, before_t = j.index, t.index
    j.apply_events(graph_stream(edges, n, 2, 2, seed=8), batch_size=4)
    t = _port_of(j)
    got = tb.changed_rows(before_t, t.index)
    np.testing.assert_array_equal(got, jb.changed_rows(before_j, j.index))
    assert got.dtype == bool and got.any()
    repadded = L.repad(t.index, t.index.l_cap * 2)
    assert not tb.changed_rows(t.index, repadded).any()
    assert not tb.changed_rows(repadded, t.index).any()
    np.testing.assert_array_equal(
        tb.changed_rows(before_t, repadded),
        jb.changed_rows(before_j, JL.repad(j.index, j.index.l_cap * 2)))
    with pytest.raises(ValueError, match="equal n"):
        tb.changed_rows(t.index, L.add_vertices(t.index, 1))


@pytest.mark.parametrize("frac", [0.5, -1.0], ids=["incremental", "full"])
def test_maintainer_over_the_same_published_stream(frac):
    """TopKBetweenness fed by each package's store over the same stream:
    scores within rtol 1e-12, equal counters, equal to the oracle."""
    n, m = 24, 60
    edges = random_graph_edges(n, m, seed=8)
    events = graph_stream(edges, n, 10, 6, seed=9)
    j, t = _pair(n, edges, l_cap=28)
    j_store, t_store = j.attach_store(), t.attach_store()
    j_eng = je.AnalyticsEngine(j_store, pair_sample=128, seed=1)
    t_eng = te.AnalyticsEngine(t_store, pair_sample=128, seed=1)
    pairs = t_eng.sample_pairs()
    for a, b in zip(pairs, j_eng.sample_pairs()):
        np.testing.assert_array_equal(a, b)
    j_m = j_eng.betweenness_maintainer(pairs, full_rescore_frac=frac)
    t_m = t_eng.betweenness_maintainer(pairs, full_rescore_frac=frac)
    current = set(edges)
    for lo in range(0, len(events), 4):
        chunk = events[lo:lo + 4]
        j.apply_events(chunk, batch_size=4)
        t.apply_events(chunk, batch_size=4)
        for op, a, b in chunk:
            e = (min(a, b), max(a, b))
            current.add(e) if op == "+" else current.discard(e)
        j_m.refresh()
        t_m.refresh()
        np.testing.assert_allclose(t_m.scores(), j_m.scores(),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(
            t_m.scores(), tb.betweenness_numpy(n, sorted(current),
                                               pairs=pairs),
            rtol=1e-9, atol=1e-9)
        assert (t_m.full_recomputes, t_m.incremental_refreshes,
                t_m.last_changed, t_m.version) == \
            (j_m.full_recomputes, j_m.incremental_refreshes,
             j_m.last_changed, j_m.version)
    assert (t_m.incremental_refreshes > 0) == (frac > 0)
    assert [v for v, _ in t_m.top(5)] == [v for v, _ in j_m.top(5)]
    before = (t_m.full_recomputes, t_m.incremental_refreshes)
    assert t_m.refresh() == t_m.top()              # same version: no-op
    assert (t_m.full_recomputes, t_m.incremental_refreshes) == before


def test_maintainer_refresh_builds_each_row_once(monkeypatch):
    """An incremental refresh builds a whole one_to_all row only for the
    endpoints whose label row changed, patches the changed columns of
    the others in one call, and scores as a fresh full recompute does
    (rtol 1e-12)."""
    n, m = 24, 60
    edges = random_graph_edges(n, m, seed=8)
    t = DynamicSPC(n, edges, l_cap=28, device="cpu")
    store = t.attach_store()
    eng = te.AnalyticsEngine(store, pair_sample=40, seed=2)
    pairs = eng.sample_pairs()
    maint = eng.betweenness_maintainer(pairs, full_rescore_frac=1.0)
    before = store.current().index
    t.apply_events(graph_stream(edges, n, 2, 1, seed=4), batch_size=4)
    changed = tb.changed_rows(before, store.current().index)
    ends = np.unique(np.concatenate(pairs))
    assert changed[ends].any() and not changed[ends].all()
    calls = {"rows": 0, "cols": 0}
    real_rows, real_cols = tb.Q.one_to_all, tb.Q.one_to_all_cols

    def rows(*a, **kw):
        calls["rows"] += 1
        return real_rows(*a, **kw)

    def cols(*a, **kw):
        calls["cols"] += 1
        return real_cols(*a, **kw)

    monkeypatch.setattr(tb.Q, "one_to_all", rows)
    monkeypatch.setattr(tb.Q, "one_to_all_cols", cols)
    maint.refresh()
    assert maint.incremental_refreshes == 1 and maint.full_recomputes == 1
    assert calls == {"rows": int(changed[ends].sum()), "cols": 1}
    fresh = tb.betweenness(store.current().index, pairs=pairs)
    np.testing.assert_allclose(maint.scores(), fresh, rtol=1e-12, atol=0)
    # an empty workload keeps no rows and scores zero
    empty = eng.betweenness_maintainer((pairs[0][:0], pairs[1][:0]))
    t.apply_events(graph_stream(edges, n, 1, 1, seed=5), batch_size=4)
    empty.refresh()
    assert empty.version == store.version and not empty.scores().any()


# -- engine ---------------------------------------------------------------
def test_engine_pins_one_snapshot_and_reads_config():
    n, m = 24, 60
    edges = random_graph_edges(n, m, seed=3)
    j, t = _pair(n, edges, l_cap=28)
    with pytest.raises(TypeError):
        te.AnalyticsEngine(object())
    store = t.attach_store()
    eng = te.AnalyticsEngine.from_config(store, SMOKE)
    j_eng = je.AnalyticsEngine.from_config(JaxStore(j.index), JAX_SMOKE)
    # the reference's candidate ladder tops out at analytics_v_block,
    # the port's one tile width
    assert (eng.pair_sample, eng.top_k, eng.v_block) == \
        (j_eng.pair_sample, j_eng.top_k, max(j_eng._v_tiles))
    assert eng.v_block == SMOKE.analytics_v_block
    for seed in (None, 5):
        for a, b in zip(eng.sample_pairs(seed=seed),
                        j_eng.sample_pairs(seed=seed)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    s, tt = eng.sample_pairs()
    assert len(set(zip(s.tolist(), tt.tolist()))) == len(s) == 64
    assert (s != tt).all()
    view = eng.pin()
    v0, before = view.version, view.betweenness()
    rec, cyc = view.recommend(0), view.cycles_through_vertex(0)
    assert eng.top_betweenness(3) == view.top_betweenness(3)
    t.apply_events(graph_stream(edges, n, 6, 3, seed=1), batch_size=4)
    assert view.version == v0 and eng.pin().version > v0
    np.testing.assert_array_equal(view.betweenness(), before)
    assert view.recommend(0) == rec
    assert view.cycles_through_vertex(0) == cyc
    assert eng.recommend(0) == tr.recommend(t.index, 0, k=eng.top_k)
    tiny = DynamicSPC(3, [(0, 1), (1, 2)], l_cap=8, device="cpu")
    s, tt = te.AnalyticsEngine(tiny.attach_store(),
                               pair_sample=100).sample_pairs()
    assert len(s) == 6                             # capped at n (n - 1)
