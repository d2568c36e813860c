"""Seeded Chung-Lu graphs and insert streams, vectorised in numpy.

A graph has exactly ``m`` distinct undirected edges over ``n`` vertices
and no self-loops.  Endpoints are drawn independently with weights
proportional to ``(i + i0) ** -alpha`` (vertex 0 the heaviest, so the
id order is the degree order that ``vertex_order = "id"`` builds on),
and the first ``m`` distinct pairs in draw order are kept: the sampling
of the program's own ``random_graph_edges`` with a head offset ``i0``,
drawn in bulk instead of one pair per Python iteration.

Both parameters are fitted to two statistics that the dataset's page
publishes: ``i0`` (:func:`fit_offset`) so that the graph's largest
degree averages the published largest degree, and
``alpha`` (:func:`fit_exponent`) so that the largest connected component
averages the published one's size (the heavier the tail of light
vertices, the more of them draw no edge).  :func:`effective_diameter`
reads a third statistic, which this model cannot fit: it has no
clustering, so its paths are shorter than the dataset's.
"""

from __future__ import annotations

import numpy as np


def weights(n: int, alpha: float, i0: float) -> np.ndarray:
    """Endpoint probabilities, float64[n], heaviest first."""
    w = (np.arange(n, dtype=np.float64) + i0) ** -alpha
    return w / w.sum()


def _first_distinct(keys: np.ndarray) -> np.ndarray:
    """``keys`` without repeats, each at its first occurrence, in order."""
    _, first = np.unique(keys, return_index=True)
    return keys[np.sort(first)]


def chung_lu_edges(n: int, m: int, alpha: float, i0: float,
                   seed) -> np.ndarray:
    """int64[m, 2] edges (lo, hi), sorted, from ``seed`` (an int or a
    ``numpy.random.SeedSequence``)."""
    if m > n * (n - 1) // 2:
        raise ValueError(f"{m} edges do not fit on {n} vertices")
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(weights(n, alpha, i0))
    keys = np.empty(0, dtype=np.int64)
    while keys.shape[0] < m:
        k = 2 * (m - keys.shape[0]) + 1024
        ab = np.minimum(np.searchsorted(cdf, rng.random((k, 2))), n - 1)
        lo, hi = ab.min(axis=1), ab.max(axis=1)
        keys = _first_distinct(np.concatenate([keys, (lo * n + hi)[lo != hi]]))
    keys = np.sort(keys[:m])
    return np.stack([keys // n, keys % n], axis=1)


def mean_top_degree(n: int, m: int, alpha: float, i0: float,
                    seeds=(0, 1, 2, 3)) -> float:
    """The largest degree averaged over graphs of ``seeds``."""
    return float(np.mean([
        np.bincount(chung_lu_edges(n, m, alpha, i0, s).reshape(-1)).max()
        for s in seeds]))


def fit_offset(n: int, m: int, alpha: float, max_degree: float,
               seeds=(0, 1, 2, 3), iters: int = 24) -> float:
    """The head offset ``i0`` at which :func:`mean_top_degree` is
    ``max_degree`` (bisection in log space; the degree falls as ``i0``
    grows)."""
    lo, hi = 0.0, np.log(n)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if mean_top_degree(n, m, alpha, float(np.exp(mid)), seeds) > max_degree:
            lo = mid
        else:
            hi = mid
    return round(float(np.exp(0.5 * (lo + hi))), 4)


def largest_component(n: int, edges: np.ndarray) -> int:
    """Vertices in the largest connected component (min-label
    propagation with pointer jumping)."""
    a, b = edges[:, 0], edges[:, 1]
    lab = np.arange(n, dtype=np.int64)
    while True:
        low = np.minimum(lab[a], lab[b])
        new = lab.copy()
        np.minimum.at(new, a, low)
        np.minimum.at(new, b, low)
        new = new[new]
        if np.array_equal(new, lab):
            return int(np.bincount(lab).max())
        lab = new


def mean_largest_component(n: int, m: int, alpha: float, i0: float,
                           seeds=(0, 1, 2, 3)) -> float:
    """:func:`largest_component` averaged over graphs of ``seeds``."""
    return float(np.mean([
        largest_component(n, chung_lu_edges(n, m, alpha, i0, s))
        for s in seeds]))


def fit_exponent(n: int, m: int, max_degree: float, component: float,
                 seeds=(0, 1, 2, 3), lo: float = 0.2, hi: float = 2.5,
                 iters: int = 12) -> tuple:
    """(alpha, i0): the exponent at which the largest component averages
    ``component`` vertices, ``i0`` refitted to ``max_degree`` at each
    (bisection; the component shrinks as ``alpha`` grows)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        i0 = fit_offset(n, m, mid, max_degree, seeds)
        if mean_largest_component(n, m, mid, i0, seeds) > component:
            lo = mid
        else:
            hi = mid
    alpha = round(0.5 * (lo + hi), 4)
    return alpha, fit_offset(n, m, alpha, max_degree, seeds)


def effective_diameter(n: int, edges: np.ndarray, sources: int = 256,
                       seed: int = 0, q: float = 0.9) -> float:
    """The ``q``-percentile effective diameter as SNAP reports it: the
    distances from ``sources`` random non-isolated vertices to every
    vertex they reach (itself at 0), and the distance at which their
    cumulative count passes ``q`` of the total, interpolated linearly
    between whole distances (SNAP's ``GetBfsEffDiam``)."""
    from spcbench.reference.spc_bfs import Graph
    g = Graph(n, edges)
    deg = np.diff(g.indptr)
    rng = np.random.default_rng(seed)
    picked = rng.choice(np.flatnonzero(deg > 0), size=sources, replace=False)
    hist = np.zeros(n, dtype=np.int64)
    for s in picked:
        d, _ = g.counts_from(int(s))
        hist += np.bincount(d[d >= 0], minlength=n)
    cdf = np.cumsum(hist)
    want = q * cdf[-1]
    v = int(np.argmax(cdf > want))
    if v == 0:
        return 1.0
    return float(v - 1 + (want - cdf[v - 1]) / (cdf[v] - cdf[v - 1]))


def insert_stream(edges: np.ndarray, n: int, count: int, seed,
                  strata: int = 1) -> np.ndarray:
    """int64[count, 2] fresh non-edges (lo, hi), distinct, in draw order:
    the insert protocol of the program's ``graph_stream`` (uniform
    endpoints, no self-loops, never an edge already present) drawn in
    bulk.

    The id order, which is the degree order, is cut into ``strata``
    blocks of equal size, and endpoint ``k`` of the stream (event ``i``'s
    are ``2i`` and ``2i + 1``) is drawn uniformly inside block
    ``ORDER[k % strata]``, where ``ORDER`` is a permutation fixed by
    ``strata`` alone: every ``strata`` endpoints hold one from each block,
    in the same order for every seed, so every seed inserts the same mix
    of heavy and light endpoints.  An endpoint that would make a
    self-loop, an edge present or a repeat is drawn again in its block.
    """
    rng = np.random.default_rng(seed)
    present = np.sort(edges[:, 0] * n + edges[:, 1])
    order = np.random.default_rng(strata).permutation(strata)
    bounds = np.linspace(0, n, strata + 1).astype(np.int64)
    block = order[np.arange(2 * count) % strata].reshape(count, 2)
    base, size = bounds[block], bounds[block + 1] - bounds[block]
    ab = np.empty((count, 2), dtype=np.int64)
    redo = np.ones(count, dtype=bool)
    for _ in range(1000):
        if not redo.any():
            return np.stack([ab.min(axis=1), ab.max(axis=1)], axis=1)
        ab[redo] = base[redo] + (rng.random((int(redo.sum()), 2))
                                 * size[redo]).astype(np.int64)
        lo, hi = ab.min(axis=1), ab.max(axis=1)
        keys = lo * n + hi
        pos = np.minimum(np.searchsorted(present, keys), present.shape[0] - 1)
        redo = (lo == hi) | (present[pos] == keys)
        _, first = np.unique(np.where(redo, -1 - np.arange(count), keys),
                             return_index=True)
        repeat = np.ones(count, dtype=bool)
        repeat[first] = False
        redo |= repeat
    raise ValueError(f"{count} fresh edges do not fit in {strata} blocks "
                     f"of {n} vertices")
