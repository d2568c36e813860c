"""Shortest-cycle counting from the SPC index.

Port of ``repro.analytics.cycles``.

Directed graphs (the port's ``core/directed.py`` labels, Appendix
C.1): a shortest path is simple, so a shortest cycle through arc
``a -> b`` is the arc plus a shortest ``b -> a`` path (one
``L_out(b) x L_in(a)`` scan), and a shortest cycle through ``v``
leaves ``v`` by exactly one out-arc, so minimising ``1 + d(w -> v)``
over out-neighbours ``w`` and summing the minimisers' counts is exact
(``src/repro/analytics/cycles.py:77-111``).  Pure Python, off the
device path.

Undirected graphs (the tensor ``SPCIndex``): both
endpoints of a cycle edge at ``v`` are neighbours of ``v``, hence at
mutual distance <= 2, so the index resolves the short end of the cycle
spectrum exactly:

* triangles through ``v``: adjacent neighbour pairs (u, w);
* quadrilaterals through ``v``: for every neighbour pair,
  ``|N(u) & N(w)| - 1`` (each common neighbour besides ``v`` closes
  ``v-u-x-w-v``);
* if both are zero, no cycle through ``v`` of length <= 4 exists; the
  result is then reported as ``certified=False``.

Neighbourhoods are recovered from the pinned snapshot alone (``d == 1``
in a one_to_all distance row), never from the updater's adjacency.

The reference sums ``masks @ masks.T`` over neighbour pairs on the
host.  The same sums come without the [k, k] product: with ``c[x]`` the
number of neighbours of ``v`` adjacent to ``x``,

    sum over pairs i < j of common(i, j) = sum over x of C(c[x], 2)
    sum over pairs i < j of adj(i, j)    = (sum over x in N(v) of c[x]) / 2

(the masks are symmetric), so the masks are formed in chunks of roots
and only ``c`` is kept: exact int64, O(k n) instead of O(k^2 n).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.directed import INF as DINF
from repro_torch.core.directed import (RefDiGraph, RefDiSPCIndex,
                                       bfs_spc_directed)
from repro_torch.core.graph import INF
from repro_torch.core.labels import SPCIndex


@dataclasses.dataclass(frozen=True)
class CycleCount:
    """Shortest cycle through a vertex/edge.

    ``length``/``count`` describe the shortest cycle found on the
    index's horizon (INF/0 when none).  ``certified`` means the result
    is exact; when False, no cycle of length <= ``horizon`` exists and
    longer ones are invisible to a shortest-path index.  ``odd_count``
    / ``even_count`` count shortest odd (length 3) and even (length 4)
    cycles on the horizon.
    """
    length: int
    count: int
    certified: bool
    horizon: int
    odd_count: int
    even_count: int


# --------------------------------------------------------------------------
# Directed: one L_out x L_in scan per quantity (exact at any length).
# --------------------------------------------------------------------------
def cycle_through_edge_directed(idx: RefDiSPCIndex, a: int,
                                b: int) -> Tuple[int, int]:
    """(length, count) of shortest cycles through arc ``a -> b``."""
    d, c = idx.query(b, a)
    if d >= DINF:
        return DINF, 0
    return d + 1, c


def cycle_through_vertex_directed(g: RefDiGraph, idx: RefDiSPCIndex,
                                  v: int) -> Tuple[int, int]:
    """(length, count) of shortest cycles through vertex ``v``; each
    such cycle uses exactly one out-arc of ``v``, so counts add."""
    best, cnt = DINF, 0
    for w in g.out[v]:
        d, c = idx.query(w, v)
        if d >= DINF:
            continue
        if d + 1 < best:
            best, cnt = d + 1, c
        elif d + 1 == best:
            cnt += c
    return best, cnt


def cycle_through_edge_directed_oracle(g: RefDiGraph, a: int,
                                       b: int) -> Tuple[int, int]:
    """Brute force: BFS from b on the raw digraph (no labels)."""
    dist, cnt = bfs_spc_directed(g, b, forward=True)
    if dist[a] >= DINF:
        return DINF, 0
    return int(dist[a]) + 1, int(cnt[a])


def cycle_through_vertex_directed_oracle(g: RefDiGraph,
                                         v: int) -> Tuple[int, int]:
    best, cnt = DINF, 0
    for w in g.out[v]:
        d, c = cycle_through_edge_directed_oracle(g, v, w)
        if d < best:
            best, cnt = d, c
        elif d == best and d < DINF:
            cnt += c
    return best, cnt


def _neighbor_masks(idx: SPCIndex, vs: torch.Tensor) -> torch.Tensor:
    """bool [K, n] adjacency masks of the sources ``vs`` (d == 1 in
    their one_to_all distance rows)."""
    d = Q.one_to_all_dist_batch(idx, vs.to(idx.device), None)
    return d[:, :idx.n] == 1


def neighbors(idx: SPCIndex, v: int) -> np.ndarray:
    """N(v) recovered from the index itself (d(v, .) == 1)."""
    d = Q.one_to_all_dist(idx, int(v))[:idx.n]
    return (d == 1).nonzero()[:, 0].cpu().numpy()


def _pair_scan(idx: SPCIndex, us: torch.Tensor, ws: torch.Tensor):
    """d/sigma for gate pairs."""
    return Q.merge_rows(*Q.gather_rows(idx, us), *Q.gather_rows(idx, ws))


def _scan_pairs(idx: SPCIndex, us: np.ndarray,
                ws: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if us.shape[0] == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    d, c = _pair_scan(idx, torch.as_tensor(us, device=idx.device).long(),
                      torch.as_tensor(ws, device=idx.device).long())
    return d.cpu().numpy().astype(np.int64), c.cpu().numpy()


def _summarize(tri: int, quad: int) -> CycleCount:
    if tri > 0:
        return CycleCount(3, tri, True, 4, tri, quad)
    if quad > 0:
        return CycleCount(4, quad, True, 4, 0, quad)
    return CycleCount(int(INF), 0, False, 4, 0, 0)


#: Roots whose neighbour masks are formed at once.
ROOT_CHUNK = 512


def cycles_through_vertex(idx: SPCIndex, v: int) -> CycleCount:
    """Shortest cycles through vertex ``v`` on the undirected index."""
    nbr = neighbors(idx, v)
    k = nbr.shape[0]
    if k < 2:
        return _summarize(0, 0)
    roots = torch.as_tensor(nbr, device=idx.device)
    c = torch.zeros(idx.n, dtype=torch.int64, device=idx.device)
    for lo in range(0, k, ROOT_CHUNK):
        c += _neighbor_masks(idx, roots[lo:lo + ROOT_CHUNK]).sum(
            dim=0, dtype=torch.int64)
    tri = int(c[roots].sum()) // 2
    quad = int((c * (c - 1) // 2).sum()) - k * (k - 1) // 2
    return _summarize(tri, quad)


def cycles_through_edge(idx: SPCIndex, a: int, b: int) -> CycleCount:
    """Shortest cycles through undirected edge {a, b}: gate pairs
    (x, y) in (N(a) - b) x (N(b) - a); x == y closes a triangle,
    d(x, y) == 1 closes a quadrilateral."""
    na = neighbors(idx, a)
    if b not in set(na.tolist()):
        raise ValueError(f"({a}, {b}) is not an edge of the snapshot")
    nb = neighbors(idx, b)
    na = na[na != b]
    nb = nb[nb != a]
    if na.size == 0 or nb.size == 0:
        return _summarize(0, 0)
    tri = int(np.intersect1d(na, nb).size)
    xs, ys = np.meshgrid(na, nb, indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    off = xs != ys
    d, _ = _scan_pairs(idx, xs[off], ys[off])
    quad = int((d == 1).sum())
    return _summarize(tri, quad)


# --------------------------------------------------------------------------
# Brute-force oracles (BFS with the gate vertex deleted; no index).
# --------------------------------------------------------------------------
def _adjacency(n: int, edges) -> List[set]:
    adj: List[set] = [set() for _ in range(n)]
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    return adj


def _bfs_spc_avoiding(n: int, adj: List[set], s: int, banned: frozenset):
    dist = np.full(n, int(INF), dtype=np.int64)
    cnt = np.zeros(n, dtype=np.int64)
    dist[s] = 0
    cnt[s] = 1
    q = collections.deque([s])
    while q:
        x = q.popleft()
        for y in adj[x]:
            if y in banned:
                continue
            if dist[y] >= INF:
                dist[y] = dist[x] + 1
                cnt[y] = cnt[x]
                q.append(y)
            elif dist[y] == dist[x] + 1:
                cnt[y] += cnt[x]
    return dist, cnt


def cycles_through_vertex_oracle(n: int, edges, v: int) -> Tuple[int, int]:
    """True (length, count) of shortest cycles through ``v``: for every
    neighbour u, shortest paths from u in G - v to the other
    neighbours; each shortest cycle is counted once per direction, then
    halved."""
    adj = _adjacency(n, edges)
    nbr = sorted(adj[v])
    best, total = int(INF), 0
    for u in nbr:
        dist, cnt = _bfs_spc_avoiding(n, adj, u, frozenset([v]))
        for w in nbr:
            if w == u or dist[w] >= INF:
                continue
            length = int(dist[w]) + 2
            if length < best:
                best, total = length, int(cnt[w])
            elif length == best:
                total += int(cnt[w])
    if best >= INF:
        return int(INF), 0
    return best, total // 2


def four_cycles_through_vertex_oracle(n: int, edges, v: int) -> int:
    """Brute-force number of quadrilaterals containing ``v``."""
    adj = _adjacency(n, edges)
    nbr = sorted(adj[v])
    total = 0
    for i, u in enumerate(nbr):
        for w in nbr[i + 1:]:
            total += len((adj[u] & adj[w]) - {v})
    return total


def triangles_through_vertex_oracle(n: int, edges, v: int) -> int:
    """Brute-force number of triangles containing ``v``."""
    adj = _adjacency(n, edges)
    nbr = sorted(adj[v])
    return sum(1 for i, u in enumerate(nbr) for w in nbr[i + 1:]
               if w in adj[u])


def cycles_through_edge_oracle(n: int, edges, a: int,
                               b: int) -> Tuple[int, int]:
    """True (length, count) of shortest cycles through edge {a, b}:
    shortest a -> b paths with the edge itself removed."""
    adj = _adjacency(n, edges)
    if b not in adj[a]:
        raise ValueError(f"({a}, {b}) is not an edge")
    adj[a].discard(b)
    adj[b].discard(a)
    dist, cnt = _bfs_spc_avoiding(n, adj, a, frozenset())
    if dist[b] >= INF:
        return int(INF), 0
    return int(dist[b]) + 1, int(cnt[b])
