"""The port's directed SPC (``repro_torch.core.directed``) and directed
cycle counting (``repro_torch.analytics.cycles``) against the JAX
package's on the same seeded digraphs: every label row, every query and
every cycle count equal, and both against the directed BFS oracle, as
``tests/core/test_directed.py`` and ``tests/analytics/test_cycles.py``
check the reference."""

import random

import numpy as np
import pytest

import repro.analytics.cycles as JC
import repro.core.directed as JD
import repro_torch.analytics as TA
import repro_torch.core.directed as TD


def _random_digraph(n, m, seed):
    rng = random.Random(seed)
    arcs = set()
    while len(arcs) < m:
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b:
            arcs.add((a, b))
    return sorted(arcs)


def _both(n, arcs):
    gj, gt = JD.RefDiGraph(n, arcs), TD.RefDiGraph(n, arcs)
    return gj, gt, JD.hp_spc_directed(gj), TD.hp_spc_directed(gt)


def _assert_same_labels(ij, it):
    assert ij.l_in == it.l_in
    assert ij.l_out == it.l_out


def test_constants_and_tiny_diamond():
    assert TD.INF == JD.INF
    gj, gt, ij, it = _both(4, [(0, 1), (0, 2), (1, 3), (2, 3)])
    _assert_same_labels(ij, it)
    assert it.query(0, 3) == (2, 2)
    assert it.query(3, 0) == it.query(1, 2) == (TD.INF, 0)
    for s in range(4):
        for fwd in (True, False):
            for a, b in zip(TD.bfs_spc_directed(gt, s, fwd),
                            JD.bfs_spc_directed(gj, s, fwd)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_construction_matches_reference_and_oracle(seed):
    n = 25
    gj, gt, ij, it = _both(n, _random_digraph(n, 60, seed))
    _assert_same_labels(ij, it)
    TD.check_espc_directed(gt, it)
    for s in range(n):
        for t in range(n):
            assert it.query(s, t) == ij.query(s, t)
            assert it.prequery(s, t, (s + t) % n) == \
                ij.prequery(s, t, (s + t) % n)


@pytest.mark.parametrize("seed", range(3))
def test_insert_stream_matches_reference(seed):
    n = 20
    gj, gt, ij, it = _both(n, _random_digraph(n, 40, seed))
    rng = random.Random(1000 + seed)
    for _ in range(10):
        while True:
            a, b = rng.randrange(n), rng.randrange(n)
            if a != b and not gt.has_edge(a, b):
                break
        JD.inc_spc_directed(gj, ij, a, b)
        TD.inc_spc_directed(gt, it, a, b)
        _assert_same_labels(ij, it)
    TD.check_espc_directed(gt, it)
    with pytest.raises(ValueError, match="already present"):
        TD.inc_spc_directed(gt, it, a, b)


def test_check_espc_catches_a_wrong_label():
    gj, gt, ij, it = _both(6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)])
    it.l_in[5] = [(h, d + 1, c) for h, d, c in it.l_in[5]]
    with pytest.raises(AssertionError, match="oracle"):
        TD.check_espc_directed(gt, it)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_directed_cycles_match_reference_and_oracle(seed):
    n = 14
    arcs = _random_digraph(n, 30, seed)
    gj, gt, ij, it = _both(n, arcs)
    rng = random.Random(seed)
    for _ in range(4):                      # an inserted arc or two
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b and not gt.has_edge(a, b):
            JD.inc_spc_directed(gj, ij, a, b)
            TD.inc_spc_directed(gt, it, a, b)
    for v in range(n):
        got = TA.cycle_through_vertex_directed(gt, it, v)
        assert got == JC.cycle_through_vertex_directed(gj, ij, v), v
        assert got == TA.cycle_through_vertex_directed_oracle(gt, v), v
        assert got == JC.cycle_through_vertex_directed_oracle(gj, v), v
    for a in range(n):
        for b in sorted(gt.out[a]):
            got = TA.cycle_through_edge_directed(it, a, b)
            assert got == JC.cycle_through_edge_directed(ij, a, b)
            assert got == TA.cycle_through_edge_directed_oracle(gt, a, b)


def test_directed_acyclic_reports_inf():
    n = 8
    arcs = [(a, b) for a in range(n) for b in range(a + 1, n) if b - a <= 2]
    g = TD.RefDiGraph(n, arcs)
    idx = TD.hp_spc_directed(g)
    for v in range(n):
        assert TA.cycle_through_vertex_directed(g, idx, v) == (TD.INF, 0)
    for a, b in arcs:
        assert TA.cycle_through_edge_directed(idx, a, b) == (TD.INF, 0)
