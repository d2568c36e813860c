"""The port's copy of the paper-faithful oracle (``repro_torch.core.
refimpl``) against the reference's (``repro.core.refimpl``), and the
conversions between it and the port's tensor index.

* The same source: every function and class of the reference's module
  is in the port's, with the same code.
* On the paper's graph: Table 2's labels (HP-SPC), Example 2.1's query,
  Figure 3's insertion and Figure 6's deletion, the SRR sets of Example
  3.13, the isolated-vertex case and vertex insertion / deletion --
  identical labels and answers in both copies, every pair through
  ``check_espc``.
* Seeded random insert, delete and mixed streams on 24-25 vertices:
  identical labels after every event, ``check_espc`` at the end.
* ``check_espc`` on the port's own index, through ``labels.to_ref`` and
  ``graph.to_ref``: after a build at the ``dspc`` SMOKE configuration
  and after an event stream of 2 chunks through ``DynamicSPC``.
* ``labels.from_ref`` byte-identical to the reference's ``from_ref``
  (with and without ``l_cap``, and on a vertex-inserted index), its
  ``l_cap`` check, and ``to_ref`` of it giving the labels back."""

import inspect
import random

import numpy as np
import pytest

from repro.core import labels as JL
from repro.core import refimpl as J
from repro_torch.configs.dspc import SMOKE
from repro_torch.core import graph as G
from repro_torch.core import labels as L
from repro_torch.core import refimpl as T
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges

PAPER_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 8), (0, 11),
    (1, 2), (1, 5), (1, 6),
    (2, 3), (2, 5),
    (3, 7), (3, 8),
    (4, 5), (4, 7), (4, 9),
    (6, 10), (9, 10),
]


def test_the_copy_is_the_reference_code():
    names = [n for n, v in vars(J).items()
             if inspect.isfunction(v) or inspect.isclass(v)]
    names = [n for n in names if getattr(J, n).__module__ == J.__name__]
    assert len(names) >= 14
    for name in names:
        assert inspect.getsource(getattr(T, name)) == \
            inspect.getsource(getattr(J, name)), name
    assert T.INF == J.INF == np.iinfo(np.int32).max // 4


def paper_pair():
    return J.RefGraph(12, PAPER_EDGES), T.RefGraph(12, PAPER_EDGES)


def test_paper_graph_table_2_and_example_2_1():
    jg, tg = paper_pair()
    ji, ti = J.hp_spc(jg), T.hp_spc(tg)
    assert ji.labels == ti.labels
    assert ti.query(4, 6) == ji.query(4, 6) == (3, 2)
    for s in range(12):
        jd, jc = J.bfs_spc(jg, s)
        td, tc = T.bfs_spc(tg, s)
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(jc, tc)
        for t in range(12):
            assert T.bibfs_spc(tg, s, t) == J.bibfs_spc(jg, s, t)
    T.check_espc(tg, ti)


@pytest.mark.parametrize("event", ["figure_3", "figure_6", "isolated",
                                   "insert_vertex", "delete_vertex"])
def test_paper_events(event):
    jg, tg = paper_pair()
    ji, ti = J.hp_spc(jg), T.hp_spc(tg)
    if event == "figure_3":
        J.inc_spc(jg, ji, 3, 9)
        T.inc_spc(tg, ti, 3, 9)
        assert ti.get(9, 0) == (0, 2, 1) and ti.get(10, 2) == (2, 3, 1)
    elif event == "figure_6":
        assert T.srr_sets(tg, ti, 1, 2) == J.srr_sets(jg, ji, 1, 2) == \
            ({1, 6, 10}, {2}, set(), {3, 7})
        J.dec_spc(jg, ji, 1, 2)
        T.dec_spc(tg, ti, 1, 2)
        assert ti.get(10, 2) == (2, 4, 1) and ti.get(3, 1) is None
    elif event == "isolated":
        J.dec_spc(jg, ji, 0, 11)
        T.dec_spc(tg, ti, 0, 11)
        assert ti.labels[11] == [(11, 0, 1)]
    elif event == "insert_vertex":
        assert J.insert_vertex(jg, ji) == T.insert_vertex(tg, ti) == 12
        for a in (4, 10):
            J.inc_spc(jg, ji, a, 12)
            T.inc_spc(tg, ti, a, 12)
    else:
        J.delete_vertex(jg, ji, 4)
        T.delete_vertex(tg, ti, 4)
        assert tg.degree(4) == 0
    assert ti.labels == ji.labels
    assert tg.edge_list() == jg.edge_list()
    T.check_espc(tg, ti)


def random_graph(mod, n, m, seed):
    rng = random.Random(seed)
    g = mod.RefGraph(n)
    edges = set()
    while len(edges) < m:
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b and (min(a, b), max(a, b)) not in edges:
            edges.add((min(a, b), max(a, b)))
            g.add_edge(a, b)
    return g


@pytest.mark.parametrize("seed", range(3))
def test_random_streams_give_identical_labels(seed):
    jg, tg = (random_graph(mod, 24, 45, seed) for mod in (J, T))
    ji, ti = J.hp_spc(jg), T.hp_spc(tg)
    assert ti.labels == ji.labels
    rng = random.Random(3000 + seed)
    for _ in range(20):
        if rng.random() < 0.6:
            while True:
                a, b = rng.randrange(tg.n), rng.randrange(tg.n)
                if a != b and not tg.has_edge(a, b):
                    break
            J.inc_spc(jg, ji, a, b)
            T.inc_spc(tg, ti, a, b)
        else:
            edges = tg.edge_list()
            a, b = edges[rng.randrange(len(edges))]
            J.dec_spc(jg, ji, a, b)
            T.dec_spc(tg, ti, a, b)
        assert ti.labels == ji.labels
    T.check_espc(tg, ti)


def test_check_espc_on_the_ports_index_after_build_and_events():
    cfg = SMOKE
    edges = random_graph_edges(cfg.n, cfg.m, seed=0)
    svc = DynamicSPC(cfg.n, edges, device="cpu", l_cap=None,
                     construct_batch=cfg.construct_batch)
    ref_g = G.to_ref(svc.graph)
    assert sorted(ref_g.edge_list()) == sorted(G.edge_set(svc.graph))
    T.check_espc(ref_g, L.to_ref(svc.index))
    half = cfg.update_batch // 2
    events = graph_stream(edges, cfg.n, 2 * half, 2 * half, seed=1)
    svc.apply_events(events, batch_size=cfg.update_batch)
    T.check_espc(G.to_ref(svc.graph), L.to_ref(svc.index))
    # a wrong count is caught
    bad = L.to_ref(svc.index)
    v = next(v for v in range(cfg.n) if len(bad.labels[v]) > 1)
    h, d, c = bad.labels[v][0]
    bad.labels[v][0] = (h, d, c + 1)
    with pytest.raises(AssertionError, match="oracle"):
        T.check_espc(G.to_ref(svc.graph), bad)


def assert_same_index(got, want):
    for f in ("hub", "dist", "cnt", "size", "cnt_sum", "overflow"):
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f
    assert got.n == want.n


@pytest.mark.parametrize("l_cap", [None, 16])
def test_from_ref_is_byte_identical_to_the_reference(l_cap):
    jg, tg = paper_pair()
    ji, ti = J.hp_spc(jg), T.hp_spc(tg)
    J.insert_vertex(jg, ji)
    T.insert_vertex(tg, ti)
    assert_same_index(L.from_ref(ti, l_cap, device="cpu"),
                      JL.from_ref(ji, l_cap))
    idx = L.from_ref(ti, l_cap, device="cpu")
    assert int(idx.hub[12, 1]) == 13 and int(idx.dist[12, 1]) == 1 << 28
    assert L.to_ref(idx).labels == ti.labels
    with pytest.raises(ValueError, match="l_cap"):
        L.from_ref(ti, 3, device="cpu")
