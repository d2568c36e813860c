"""Directed-graph extension of DSPC (paper Appendix C.1).

The port's own copy of ``repro.core.directed`` (pure Python and numpy,
no tensors: this code is off the device path).  Each vertex carries two
label sets: L_in(v) covers shortest paths *into* v (hubs are path
sources), L_out(v) covers paths *out of* v.  SPC(s, t) scans
L_out(s) x L_in(t).  Construction runs two pruned BFSs per hub (forward
into L_in of reached vertices, backward into L_out).  Incremental
updates root at hubs of L_in(a) (forward BFS from b) and L_out(b)
(backward BFS from a), mirroring Algorithm 2/3 with direction.

Ids are ranks, 0 = highest, as in the reference
(``src/repro/core/directed.py:1-232``).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Set, Tuple

import numpy as np

INF = np.iinfo(np.int32).max // 4

Label = Tuple[int, int, int]


class RefDiGraph:
    """Mutable directed graph."""

    def __init__(self, n: int, edges=()) -> None:
        self.n = n
        self.out: List[Set[int]] = [set() for _ in range(n)]
        self.inn: List[Set[int]] = [set() for _ in range(n)]
        for a, b in edges:
            self.add_edge(a, b)

    def add_edge(self, a: int, b: int) -> None:
        if a == b:
            raise ValueError("self loops are not allowed")
        self.out[a].add(b)
        self.inn[b].add(a)

    def has_edge(self, a: int, b: int) -> bool:
        return b in self.out[a]


def bfs_spc_directed(g: RefDiGraph, s: int, forward: bool = True):
    """(dist, count) from s following out-edges (or in-edges)."""
    adj = g.out if forward else g.inn
    dist = np.full(g.n, INF, dtype=np.int64)
    cnt = np.zeros(g.n, dtype=np.int64)
    dist[s] = 0
    cnt[s] = 1
    q = collections.deque([s])
    while q:
        v = q.popleft()
        for w in adj[v]:
            if dist[w] == INF:
                dist[w] = dist[v] + 1
                cnt[w] = cnt[v]
                q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]
    return dist, cnt


class RefDiSPCIndex:
    """L_in / L_out label sets, hub-sorted ascending."""

    def __init__(self, n: int) -> None:
        self.l_in: List[List[Label]] = [[] for _ in range(n)]
        self.l_out: List[List[Label]] = [[] for _ in range(n)]

    @staticmethod
    def _insert(row: List[Label], lab: Label) -> None:
        for i, (h, _, _) in enumerate(row):
            if h == lab[0]:
                row[i] = lab
                return
            if h > lab[0]:
                row.insert(i, lab)
                return
        row.append(lab)

    @staticmethod
    def _get(row: List[Label], h: int):
        for lab in row:
            if lab[0] == h:
                return lab
        return None

    def query(self, s: int, t: int) -> Tuple[int, int]:
        """spc(s -> t) via L_out(s) x L_in(t) merge."""
        d, c = INF, 0
        i = j = 0
        ls, lt = self.l_out[s], self.l_in[t]
        while i < len(ls) and j < len(lt):
            hs, ds_, cs_ = ls[i]
            ht, dt_, ct_ = lt[j]
            if hs < ht:
                i += 1
            elif hs > ht:
                j += 1
            else:
                dd = ds_ + dt_
                if dd < d:
                    d, c = dd, cs_ * ct_
                elif dd == d:
                    c += cs_ * ct_
                i += 1
                j += 1
        return d, c

    def prequery(self, s: int, t: int, limit: int) -> Tuple[int, int]:
        """query restricted to hubs ranked strictly higher than limit."""
        d, c = INF, 0
        i = j = 0
        ls, lt = self.l_out[s], self.l_in[t]
        while i < len(ls) and j < len(lt):
            hs, ds_, cs_ = ls[i]
            ht, dt_, ct_ = lt[j]
            if min(hs, ht) >= limit:
                break
            if hs < ht:
                i += 1
            elif hs > ht:
                j += 1
            else:
                dd = ds_ + dt_
                if dd < d:
                    d, c = dd, cs_ * ct_
                elif dd == d:
                    c += cs_ * ct_
                i += 1
                j += 1
        return d, c


def hp_spc_directed(g: RefDiGraph) -> RefDiSPCIndex:
    """Two rank-restricted pruned BFSs per hub (Appendix C.1)."""
    idx = RefDiSPCIndex(g.n)
    for v in range(g.n):
        for forward in (True, False):
            adj = g.out if forward else g.inn
            dist = {v: 0}
            cnt = {v: 1}
            q = collections.deque([v])
            while q:
                w = q.popleft()
                if forward:
                    dq, _ = idx.prequery(v, w, v) if v != w else (INF, 0)
                else:
                    dq, _ = idx.prequery(w, v, v) if v != w else (INF, 0)
                if dq < dist[w]:
                    continue
                if forward:
                    idx._insert(idx.l_in[w], (v, dist[w], cnt[w]))
                else:
                    idx._insert(idx.l_out[w], (v, dist[w], cnt[w]))
                for u in adj[w]:
                    if u < v:
                        continue
                    if u not in dist:
                        dist[u] = dist[w] + 1
                        cnt[u] = cnt[w]
                        q.append(u)
                    elif dist[u] == dist[w] + 1:
                        cnt[u] += cnt[w]
    return idx


def _inc_update_directed(g: RefDiGraph, idx: RefDiSPCIndex, h: int,
                         seed_d: int, seed_c: int, start: int,
                         forward: bool) -> None:
    """Pruned directed BFS from ``start`` updating (h, ., .) labels in
    L_in (forward) or L_out (backward)."""
    adj = g.out if forward else g.inn
    rows = idx.l_in if forward else idx.l_out
    dist: Dict[int, int] = {start: seed_d}
    cnt: Dict[int, int] = {start: seed_c}
    q = collections.deque([start])
    while q:
        v = q.popleft()
        d_l, _ = idx.query(h, v) if forward else idx.query(v, h)
        if d_l < dist[v]:
            continue
        old = idx._get(rows[v], h)
        if old is not None:
            _, d_i, c_i = old
            d, c = dist[v], cnt[v]
            if d == d_i:
                c += c_i
            idx._insert(rows[v], (h, d, c))
        else:
            idx._insert(rows[v], (h, dist[v], cnt[v]))
        for w in adj[v]:
            if w not in dist:
                if h <= w:
                    dist[w] = dist[v] + 1
                    cnt[w] = cnt[v]
                    q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]


def inc_spc_directed(g: RefDiGraph, idx: RefDiSPCIndex, a: int,
                     b: int) -> None:
    """Insert directed edge (a -> b) and repair the index: hubs from
    L_in(a) run forward BFS from b; hubs from L_out(b) run backward BFS
    from a (Appendix C.1)."""
    if g.has_edge(a, b):
        raise ValueError(f"edge ({a},{b}) already present")
    g.add_edge(a, b)
    aff_in = {h: (d, c) for (h, d, c) in idx.l_in[a]}
    aff_out = {h: (d, c) for (h, d, c) in idx.l_out[b]}
    for h in sorted(set(aff_in) | set(aff_out)):
        if h in aff_in and h <= b:
            d, c = aff_in[h]
            _inc_update_directed(g, idx, h, d + 1, c, b, forward=True)
        if h in aff_out and h <= a:
            d, c = aff_out[h]
            _inc_update_directed(g, idx, h, d + 1, c, a, forward=False)


def check_espc_directed(g: RefDiGraph, idx: RefDiSPCIndex) -> None:
    for s in range(g.n):
        dist, cnt = bfs_spc_directed(g, s, forward=True)
        for t in range(g.n):
            d_true = int(dist[t]) if dist[t] < INF else INF
            d_idx, c_idx = idx.query(s, t)
            assert (d_idx, c_idx) == (d_true, int(cnt[t])), (
                f"query({s}->{t}) = ({d_idx},{c_idx}), "
                f"oracle = ({d_true},{int(cnt[t])})")
