"""The reference's counts against brute-force path enumeration."""

import itertools

import numpy as np
import pytest

from spcbench.reference.spc_bfs import UNREACHED, Graph, answer


def brute(n, edges, s, t):
    """(dist, count) of the shortest s-t paths by enumerating every
    simple path."""
    adj = {v: set() for v in range(n)}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    lengths = []

    def walk(v, seen, depth):
        if v == t:
            lengths.append(depth)
            return
        for w in adj[v]:
            if w not in seen:
                walk(w, seen | {w}, depth + 1)

    walk(s, {s}, 0)
    if not lengths:
        return UNREACHED, 0
    best = min(lengths)
    return best, lengths.count(best)


@pytest.mark.parametrize("seed", range(6))
def test_counts_equal_path_enumeration(seed):
    rng = np.random.default_rng(seed)
    n = 8
    pairs = [p for p in itertools.combinations(range(n), 2)
             if rng.random() < 0.35]
    g = Graph(n, pairs)
    for s in range(n):
        dist, cnt = g.counts_from(s)
        for t in range(n):
            assert (dist[t], cnt[t]) == brute(n, pairs, s, t)


def test_diamond_ladder_counts_double():
    """k diamonds in series: 2**k shortest paths end to end."""
    k, edges = 20, []
    for i in range(k):
        a, l, r, b = 3 * i, 3 * i + 1, 3 * i + 2, 3 * i + 3
        edges += [(a, l), (a, r), (l, b), (r, b)]
    g = Graph(3 * k + 1, edges)
    d, c = g.counts_from(0)
    assert d[3 * k] == 2 * k and c[3 * k] == 2 ** k


def test_answer_by_pairs_and_unreached():
    g = Graph(5, [(0, 1), (1, 2), (0, 2)])
    d, c = answer(g, np.array([0, 0, 3, 2]), np.array([2, 4, 3, 0]))
    assert d.tolist() == [1, UNREACHED, 0, 1]
    assert c.tolist() == [1, 0, 1, 1]
