"""Parity of the port's graph, label and ordering helpers with the JAX
reference: the same numpy inputs, made from a seed, go through
``repro.core.{graph,labels,order}`` and ``repro_torch.core.{graph,
labels,order}`` on the CPU, and every output array must be equal,
element for element and dtype for dtype (integer arrays: exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import labels as JL
from repro.core import order as JO
from repro_torch.core import graph as TG
from repro_torch.core import labels as TL
from repro_torch.core import order as TO
from repro_torch.data import random_graph_edges

INF = 1 << 28


def host(x):
    """A numpy copy of a JAX array, torch tensor or Python scalar."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    a, b = host(a), host(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_graph_equal(jg, tg):
    assert jg.n == tg.n
    assert_same(jg.src, tg.src, "src")
    assert_same(jg.dst, tg.dst, "dst")
    assert int(jg.m2) == tg.m2


def assert_index_equal(ji, ti):
    assert ji.n == ti.n
    for f in ("hub", "dist", "cnt", "size", "cnt_sum", "overflow"):
        assert_same(getattr(ji, f), getattr(ti, f), f)
    # the cached bound stays exact on both sides
    assert_same(TL.recompute_cnt_sum(ti.cnt), ti.cnt_sum, "cnt_sum inv")


def random_rows(n, l_cap, seed, full_frac=0.25):
    """Sorted label rows of an (n + 1)-row index; a share of rows full
    (so inserts overflow), the dump row empty, counts up to 2^40."""
    rng = np.random.default_rng(seed)
    hub = np.full((n + 1, l_cap), n, np.int32)
    dist = np.full((n + 1, l_cap), INF, np.int32)
    cnt = np.zeros((n + 1, l_cap), np.int64)
    size = np.zeros(n + 1, np.int32)
    for v in range(n):
        k = l_cap if rng.random() < full_frac else int(
            rng.integers(0, l_cap))
        k = min(k, n)
        hub[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
        dist[v, :k] = rng.integers(0, 10, k)
        cnt[v, :k] = rng.integers(1, 1 << 40, k)
        size[v] = k
    return hub, dist, cnt, size


def index_pair(n, l_cap, seed):
    hub, dist, cnt, size = random_rows(n, l_cap, seed)
    ji = JL.SPCIndex(hub=jnp.asarray(hub), dist=jnp.asarray(dist),
                     cnt=jnp.asarray(cnt), size=jnp.asarray(size),
                     cnt_sum=JL.recompute_cnt_sum(jnp.asarray(cnt)),
                     overflow=jnp.int32(0), n=n)
    ti = TL.index_from_numpy(n, hub, dist, cnt, size, device="cpu")
    return ji, ti


def graph_pair(n, m, seed, cap_e=None):
    edges = random_graph_edges(n, m, seed=seed)
    return (edges, JG.from_edges(n, edges, cap_e),
            TG.from_edges(n, edges, cap_e, device="cpu"))


# -- graph ---------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_helpers_match(seed):
    n = 24
    edges, jg, tg = graph_pair(n, 40, seed)
    assert_graph_equal(jg, tg)
    assert_same(JG.degrees(jg), TG.degrees(tg), "degrees")
    rng = np.random.default_rng(seed)
    present = set(edges)
    for _ in range(6):  # inserts of fresh edges, with capacity growth
        while True:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            if a != b and (min(a, b), max(a, b)) not in present:
                break
        present.add((min(a, b), max(a, b)))
        jg = JG.insert_edge(JG.ensure_capacity(jg, 2), a, b)
        tg = TG.insert_edge(TG.ensure_capacity(tg, 2), a, b)
        assert_graph_equal(jg, tg)
    for a, b in sorted(present)[::3]:  # deletes, both directions
        jg, tg = JG.delete_edge(jg, b, a), TG.delete_edge(tg, b, a)
        assert_graph_equal(jg, tg)
        assert bool(JG.has_edge(jg, a, b)) == TG.has_edge(tg, a, b) is False
    # an absent edge tombstones slot 0 in both (argmax of all-False)
    assert_graph_equal(JG.delete_edge(jg, 0, 0), TG.delete_edge(tg, 0, 0))
    assert_graph_equal(JG.compact(jg), TG.compact(tg))
    assert_graph_equal(JG.ensure_capacity(jg, jg.cap_e),
                       TG.ensure_capacity(tg, tg.cap_e))
    assert_graph_equal(JG.add_vertices(jg, 3), TG.add_vertices(tg, 3))
    assert_same(JG.degrees(jg), TG.degrees(tg), "degrees after")
    assert int(jg.num_active_directed) == tg.num_active_directed


def test_from_edges_errors_and_capacity():
    for bad, msg in (([(1, 1)], "self loops"), ([(0, 1), (1, 0)],
                                                "duplicate edge")):
        with pytest.raises(ValueError, match=msg):
            JG.from_edges(4, bad)
        with pytest.raises(ValueError, match=msg):
            TG.from_edges(4, bad, device="cpu")
    with pytest.raises(ValueError, match="cap_e"):
        TG.from_edges(4, [(0, 1), (1, 2)], cap_e=2, device="cpu")
    assert_graph_equal(JG.from_edges(5, []), TG.from_edges(5, [],
                                                           device="cpu"))
    assert_graph_equal(JG.from_edges(5, [(0, 4)], cap_e=4),
                       TG.from_edges(5, [(0, 4)], cap_e=4, device="cpu"))


# -- labels ----------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_layout_helpers_match(seed):
    n, l_cap = 20, 8
    ji, ti = index_pair(n, l_cap, seed)
    assert_index_equal(ji, ti)
    assert_index_equal(JL.empty_index(n, l_cap),
                       TL.empty_index(n, l_cap, device="cpu"))
    assert_index_equal(JL.repad(ji, 12), TL.repad(ti, 12))
    with pytest.raises(ValueError):
        TL.repad(ti, 4)
    assert_index_equal(JL.add_vertices(ji, 2), TL.add_vertices(ti, 2))
    for v in (0, 7, n - 1):
        assert_index_equal(JL.reset_isolated_row(ji, v),
                           TL.reset_isolated_row(ti, v))
    for v, h in ((3, 0), (5, 11), (9, 19), (n - 1, 4)):
        jf, jd, jc = JL.get_label(ji, v, h)
        tf, td, tc = TL.get_label(ti, v, h)
        assert (bool(jf), int(jd), int(jc)) == (bool(tf), int(td), int(tc))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bulk_mutations_match(seed):
    n, l_cap = 20, 8
    rng = np.random.default_rng(100 + seed)
    ji, ti = index_pair(n, l_cap, seed)
    for step in range(6):
        h = int(rng.integers(0, n))
        d_new = rng.integers(0, 10, n + 1).astype(np.int32)
        c_new = rng.integers(1, 1 << 40, n + 1).astype(np.int64)
        mask = rng.random(n + 1) < 0.6
        mask[n] = False
        args_j = (jnp.asarray(d_new), jnp.asarray(c_new), jnp.asarray(mask))
        args_t = (torch.from_numpy(d_new), torch.from_numpy(c_new),
                  torch.from_numpy(mask))
        ji = JL.bulk_upsert(ji, h, *args_j)
        ti = TL.bulk_upsert(ti, h, *args_t)
        assert_index_equal(ji, ti)
        h_rm = int(rng.integers(0, n))
        rm = rng.random(n + 1) < 0.5
        ji = JL.bulk_remove(ji, h_rm, jnp.asarray(rm))
        ti = TL.bulk_remove(ti, h_rm, torch.from_numpy(rm))
        assert_index_equal(ji, ti)
    assert int(host(ji.overflow)) > 0  # full rows overflowed on insert


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_append_matches(seed):
    n, l_cap = 20, 6
    rng = np.random.default_rng(200 + seed)
    ji, ti = index_pair(n, l_cap, seed)
    for h in (n - 3, n - 2, n - 1):  # appends keep rows sorted
        d_new = rng.integers(0, 10, n + 1).astype(np.int32)
        c_new = rng.integers(1, 1 << 40, n + 1).astype(np.int64)
        mask = rng.random(n + 1) < 0.7
        ji = JL.bulk_append(ji, h, jnp.asarray(d_new), jnp.asarray(c_new),
                            jnp.asarray(mask))
        ti = TL.bulk_append(ti, h, torch.from_numpy(d_new),
                            torch.from_numpy(c_new), torch.from_numpy(mask))
        assert_index_equal(ji, ti)
    assert int(host(ti.overflow)) > 0


@pytest.mark.parametrize("seed,h0,lanes", [(0, 12, 4), (1, 16, 8),
                                           (2, 0, 1)])
def test_bulk_append_batch_matches(seed, h0, lanes):
    """Lanes that do not fit are dropped (the reference's scatter
    ``mode="drop"``) and counted in ``overflow``; tail lanes with
    ``h0 + b >= n`` arrive unmasked."""
    n, l_cap = 20, 6
    rng = np.random.default_rng(300 + seed)
    hub, dist, cnt, size = random_rows(n, l_cap, seed)
    keep = hub < h0  # construction state: only hubs < h0 exist yet
    for v in range(n + 1):
        k = int(keep[v].sum())
        hub[v, k:], dist[v, k:], cnt[v, k:], size[v] = n, INF, 0, k
    ji = JL.SPCIndex(hub=jnp.asarray(hub), dist=jnp.asarray(dist),
                     cnt=jnp.asarray(cnt), size=jnp.asarray(size),
                     cnt_sum=JL.recompute_cnt_sum(jnp.asarray(cnt)),
                     overflow=jnp.int32(0), n=n)
    ti = TL.index_from_numpy(n, hub, dist, cnt, size, device="cpu")
    d_new = rng.integers(0, 10, (lanes, n + 1)).astype(np.int32)
    c_new = rng.integers(1, 1 << 40, (lanes, n + 1)).astype(np.int64)
    mask = rng.random((lanes, n + 1)) < 0.8
    mask[:, n] = False
    mask[np.arange(lanes) + h0 >= n] = False
    ji = JL.bulk_append_batch(ji, h0, jnp.asarray(d_new), jnp.asarray(c_new),
                              jnp.asarray(mask))
    ti = TL.bulk_append_batch(ti, h0, torch.from_numpy(d_new),
                              torch.from_numpy(c_new),
                              torch.from_numpy(mask))
    assert_index_equal(ji, ti)
    if lanes > 1:
        assert int(host(ti.overflow)) > 0


# -- orderings -------------------------------------------------------------
@pytest.mark.parametrize("order", ["id", "degree"])
def test_orderings_match(order):
    n = 30
    edges, jg, tg = graph_pair(n, 70, 5)
    jo, to = JO.vertex_ordering(n, edges, order), TO.vertex_ordering(
        n, edges, order)
    for f in ("rank_of", "vertex_of"):
        assert_same(getattr(jo, f), getattr(to, f), f)
    assert (jo.order, jo.identity) == (to.order, to.identity)
    go_j, go_t = JO.graph_ordering(jg, order), TO.graph_ordering(tg, order)
    assert_same(go_j.vertex_of, go_t.vertex_of, "graph_ordering")
    assert_same(go_j.vertex_of, jo.vertex_of, "graph == edge ordering")
    assert_graph_equal(JO.relabel_graph(jg, go_j),
                       TO.relabel_graph(tg, go_t))
    ids = np.asarray([0, 5, 29])
    assert_same(jo.to_internal(ids), to.to_internal(ids))
    assert_same(jo.to_external(ids), to.to_external(ids))
    assert jo.to_internal(7) == to.to_internal(7)
    assert_same(jo.grow(2).vertex_of, to.grow(2).vertex_of)
    back = TO.ordering_from_state(to.vertex_of)
    assert_same(back.rank_of, to.rank_of)
    assert back.identity == (order == "id")
    with pytest.raises(ValueError, match="unknown vertex order"):
        TO.vertex_ordering(n, edges, "bogus")


def test_ordering_validation_errors():
    with pytest.raises(ValueError, match="not a permutation"):
        TO.ordering_from_state(np.asarray([0, 0, 2]))
    o = TO.vertex_ordering(4, [(0, 1), (1, 2), (1, 3)], "degree")
    with pytest.raises(ValueError, match="out of range"):
        o.to_internal([0, 4])
