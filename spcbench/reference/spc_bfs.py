"""Shortest-path distances and counts by breadth-first search, in numpy.

The plain reference that decides ``correct``: it shares no code and no
data with the program under test.  It works from an edge list, the same
one the benchmark hands the program, and counts, for one source at a
time, the shortest paths to every vertex level by level:

    cnt[w] = sum of cnt[u] over the edges (u, w) with dist[u] + 1 == dist[w]

Counts are int64, as the configurations state, unless a narrower
``count_dtype`` is asked for (the control: the same search counting in
int32 or float32); distances are int32 with ``UNREACHED`` where no path
exists (the program answers those with its own infinity and a count of
0).
"""

from __future__ import annotations

import numpy as np

UNREACHED = -1


class Graph:
    """An undirected simple graph in compressed adjacency form."""

    def __init__(self, n: int, edges) -> None:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.argsort(src, kind="stable")
        self.n = int(n)
        self.nbr = dst[order]
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=self.indptr[1:])

    def counts_from(self, s: int, count_dtype=np.int64):
        """(dist int32[n], cnt[n]) of the shortest paths from ``s``."""
        dist = np.full(self.n, UNREACHED, dtype=np.int32)
        cnt = np.zeros(self.n, dtype=count_dtype)
        dist[s], cnt[s] = 0, 1
        front = np.array([s], dtype=np.int64)
        level = 0
        while front.size:
            start = self.indptr[front]
            deg = self.indptr[front + 1] - start
            first = np.repeat(np.cumsum(deg) - deg, deg)
            slot = np.repeat(start, deg) + np.arange(first.size) - first
            w = self.nbr[slot]
            fresh = dist[w] == UNREACHED
            w, via = w[fresh], np.repeat(front, deg)[fresh]
            nxt, inv = np.unique(w, return_inverse=True)
            acc = np.zeros(nxt.size, dtype=count_dtype)
            np.add.at(acc, inv, cnt[via])
            level += 1
            dist[nxt], cnt[nxt] = level, acc
            front = nxt
        return dist, cnt


def answer(graph: Graph, s: np.ndarray, t: np.ndarray,
           count_dtype=np.int64):
    """(dist, cnt) of the pairs (s[i], t[i]): one search per distinct
    source."""
    s = np.asarray(s, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    dist = np.empty(s.shape, dtype=np.int32)
    cnt = np.empty(s.shape, dtype=count_dtype)
    for src in np.unique(s):
        at = s == src
        d, c = graph.counts_from(int(src), count_dtype)
        dist[at], cnt[at] = d[t[at]], c[t[at]]
    return dist, cnt
