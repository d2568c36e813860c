"""Paper-faithful reference implementation of DSPC (pure Python / numpy).

The port's own copy of ``repro.core.refimpl`` (the port imports nothing
of ``repro``), the same code.  It transcribes the paper's algorithms
*exactly* as published:

* ``SpcQuery``   -- Algorithm 1 (2-hop query over the SPC-Index).
* ``hp_spc``     -- HP-SPC construction of [Zhang & Yu, SIGMOD'20] as
                    described in Section 2.2 (rank-restricted pruned BFS).
* ``IncSPC``     -- Algorithm 2 + 3 (incremental update for edge insertion).
* ``DecSPC``     -- Algorithm 4 + 5 + 6 (decremental update for deletion),
                    including the isolated-vertex optimization (S 3.2.3).
* ``bfs_spc`` / ``bibfs_spc`` -- the online baselines (BFS / bidirectional
                    BFS counting), used both as the query-time baseline of
                    Figure 7(c) and as the ground-truth oracle for tests.

Vertex ranking convention: vertices are *relabeled by rank* so that vertex
id 0 is the highest-ranked vertex.  Under this convention ``u <= v``
(rank comparison in the paper) is simply ``u <= v`` on ids.

The tensor index of ``repro_torch.core`` converts to and from this one
(``core.graph.to_ref``, ``core.labels.to_ref`` / ``from_ref``), so the
examples and tests hold it against this oracle (``check_espc``).
Unreachable distances here are ``INF`` = int32 max // 4, not the
tensor index's ``1 << 28``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

INF = np.iinfo(np.int32).max // 4  # large sentinel, safe to add small ints


# --------------------------------------------------------------------------
# Graph: adjacency as list of sorted sets (undirected, unweighted).
# --------------------------------------------------------------------------
class RefGraph:
    """Mutable undirected graph keyed by contiguous int vertex ids."""

    def __init__(self, n: int, edges: Iterable[Tuple[int, int]] = ()) -> None:
        self.n = n
        self.adj: List[Set[int]] = [set() for _ in range(n)]
        for a, b in edges:
            self.add_edge(a, b)

    @property
    def m(self) -> int:
        return sum(len(s) for s in self.adj) // 2

    def add_vertex(self) -> int:
        self.adj.append(set())
        self.n += 1
        return self.n - 1

    def has_edge(self, a: int, b: int) -> bool:
        return b in self.adj[a]

    def add_edge(self, a: int, b: int) -> None:
        if a == b:
            raise ValueError("self loops are not allowed")
        self.adj[a].add(b)
        self.adj[b].add(a)

    def remove_edge(self, a: int, b: int) -> None:
        self.adj[a].discard(b)
        self.adj[b].discard(a)

    def degree(self, v: int) -> int:
        return len(self.adj[v])

    def copy(self) -> "RefGraph":
        g = RefGraph(self.n)
        g.adj = [set(s) for s in self.adj]
        return g

    def edge_list(self) -> List[Tuple[int, int]]:
        return [(a, b) for a in range(self.n) for b in self.adj[a] if a < b]


# --------------------------------------------------------------------------
# Online baselines / oracle.
# --------------------------------------------------------------------------
def bfs_spc(g: RefGraph, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Single-source BFS computing (dist, count) to every vertex.

    Counts use Python ints promoted into an object array when they could
    exceed int64; in practice our test graphs stay well within int64.
    """
    dist = np.full(g.n, INF, dtype=np.int64)
    cnt = np.zeros(g.n, dtype=np.int64)
    dist[s] = 0
    cnt[s] = 1
    q = collections.deque([s])
    while q:
        v = q.popleft()
        for w in g.adj[v]:
            if dist[w] == INF:
                dist[w] = dist[v] + 1
                cnt[w] = cnt[v]
                q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]
    return dist, cnt


def bibfs_spc(g: RefGraph, s: int, t: int) -> Tuple[int, int]:
    """Bidirectional BFS shortest-path counting (the BiBFS baseline).

    Counting with two frontiers needs care: summing ``cs[v] * ct[v]`` over
    *all* doubly-visited vertices counts each path once per vertex inside
    both radii.  Instead, once the searches meet we count across a single
    cut: every shortest path crosses exactly one vertex at distance ``q``
    from ``s`` for any fixed ``0 <= q <= D``, so we pick a cut level that is
    fully accumulated on both sides (``q = min(L_s, D)``).
    """
    if s == t:
        return 0, 1
    ds = {s: 0}
    dt = {t: 0}
    cs = {s: 1}
    ct = {t: 1}
    fs, ft = [s], [t]
    level_s = level_t = 0  # completed BFS level per side
    while fs and ft:
        # Expand the smaller frontier (paper's heuristic).
        if len(fs) <= len(ft):
            frontier, d, c, level = fs, ds, cs, level_s
            level_s += 1
        else:
            frontier, d, c, level = ft, dt, ct, level_t
            level_t += 1
        nxt: List[int] = []
        for v in frontier:
            for w in g.adj[v]:
                if w not in d:
                    d[w] = level + 1
                    c[w] = c[v]
                    nxt.append(w)
                elif d[w] == level + 1:
                    c[w] += c[v]
        frontier[:] = nxt
        common = ds.keys() & dt.keys()
        if common:
            best = min(ds[v] + dt[v] for v in common)
            q = min(level_s, best)  # cut level; best - q <= level_t holds
            total = sum(
                cs[v] * ct[v]
                for v in common
                if ds[v] == q and dt[v] == best - q
            )
            return best, total
    return INF, 0


# --------------------------------------------------------------------------
# SPC-Index: per-vertex label list [(hub, dist, count)] sorted by hub id
# ascending (== descending rank, matching the paper's storage order).
# --------------------------------------------------------------------------
Label = Tuple[int, int, int]


class RefSPCIndex:
    def __init__(self, n: int) -> None:
        self.labels: List[List[Label]] = [[] for _ in range(n)]

    # -- label-set helpers -------------------------------------------------
    def hubs(self, v: int) -> List[int]:
        return [h for (h, _, _) in self.labels[v]]

    def get(self, v: int, h: int) -> Label | None:
        for lab in self.labels[v]:
            if lab[0] == h:
                return lab
        return None

    def insert(self, v: int, lab: Label) -> None:
        """Sorted insert (by hub id ascending); replaces existing hub entry."""
        row = self.labels[v]
        for i, (h, _, _) in enumerate(row):
            if h == lab[0]:
                row[i] = lab
                return
            if h > lab[0]:
                row.insert(i, lab)
                return
        row.append(lab)

    def remove(self, v: int, h: int) -> None:
        self.labels[v] = [lab for lab in self.labels[v] if lab[0] != h]

    def add_vertex(self) -> None:
        self.labels.append([])

    def size_entries(self) -> int:
        return sum(len(r) for r in self.labels)

    # -- Algorithm 1: SpcQuery --------------------------------------------
    def query(self, s: int, t: int) -> Tuple[int, int]:
        d, c = INF, 0
        i = j = 0
        ls, lt = self.labels[s], self.labels[t]
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

    # -- PreQuery(s, t): query restricted to hubs ranked higher than s ----
    def prequery(self, s: int, t: int) -> Tuple[int, int]:
        d, c = INF, 0
        i = j = 0
        ls, lt = self.labels[s], self.labels[t]
        while i < len(ls) and j < len(lt):
            hs, ds_, cs_ = ls[i]
            ht, dt_, ct_ = lt[j]
            h = min(hs, ht)
            if h >= s:  # "if h = s then break" -- hubs are rank-sorted
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


# --------------------------------------------------------------------------
# HP-SPC construction (Section 2.2).
# --------------------------------------------------------------------------
def hp_spc(g: RefGraph) -> RefSPCIndex:
    """Hub-pushing construction: rank-restricted pruned BFS per vertex.

    For hub v (in descending rank = ascending id) BFS inside G_v (ids >= v).
    At each visited w: if a *strictly* shorter v-w distance is available via
    already-ranked hubs (PreQuery), prune; otherwise record (v, D[w], C[w])
    which equals spc(v-hat, w) by the rank restriction.
    """
    idx = RefSPCIndex(g.n)
    for v in range(g.n):
        dist = {v: 0}
        cnt = {v: 1}
        q = collections.deque([v])
        while q:
            w = q.popleft()
            d_query, _ = idx.prequery(v, w) if v != w else (INF, 0)
            if d_query < dist[w]:
                continue  # pruned: covered by higher-ranked hubs
            idx.insert(w, (v, dist[w], cnt[w]))
            for u in g.adj[w]:
                if u < v:
                    continue  # rank restriction: stay inside G_v
                if u not in dist:
                    dist[u] = dist[w] + 1
                    cnt[u] = cnt[w]
                    q.append(u)
                elif dist[u] == dist[w] + 1:
                    cnt[u] += cnt[w]
        # NOTE: counts accumulated after w was popped cannot occur in FIFO
        # order for unweighted BFS (all same-level parents pop before w).
    return idx


# --------------------------------------------------------------------------
# IncSPC (Algorithms 2 and 3).
# --------------------------------------------------------------------------
def _inc_update(g: RefGraph, idx: RefSPCIndex, h: int, va: int, vb: int) -> None:
    """Algorithm 3: pruned BFS rooted at hub h, entering through (va, vb)."""
    lab = idx.get(va, h)
    if lab is None:  # defensive: caller guarantees membership
        return
    _, d0, c0 = lab
    dist: Dict[int, int] = {vb: d0 + 1}
    cnt: Dict[int, int] = {vb: c0}
    q = collections.deque([vb])
    while q:
        v = q.popleft()
        d_l, _ = idx.query(h, v)
        if d_l < dist[v]:
            continue  # existing index already covers SP(h, v)
        old = idx.get(v, h)
        if old is not None:
            _, d_i, c_i = old
            d, c = dist[v], cnt[v]
            if d == d_i:
                c += c_i  # new equal-length paths: accumulate
            idx.insert(v, (h, d, c))
        else:
            idx.insert(v, (h, dist[v], cnt[v]))
        for w in g.adj[v]:
            if w not in dist:
                if h <= w:  # rank pruning
                    dist[w] = dist[v] + 1
                    cnt[w] = cnt[v]
                    q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]


def inc_spc(g: RefGraph, idx: RefSPCIndex, a: int, b: int) -> None:
    """Algorithm 2: maintain the index after inserting edge (a, b).

    Mutates ``g`` (inserting the edge) and ``idx`` in place.
    """
    if g.has_edge(a, b):
        raise ValueError(f"edge ({a},{b}) already present")
    g.add_edge(a, b)
    aff = sorted(set(idx.hubs(a)) | set(idx.hubs(b)))  # ascending id = rank order
    hubs_a = set(idx.hubs(a))
    hubs_b = set(idx.hubs(b))
    for h in aff:  # descending rank
        if h in hubs_a and h <= b:
            _inc_update(g, idx, h, a, b)
        if h in hubs_b and h <= a:
            _inc_update(g, idx, h, b, a)


# --------------------------------------------------------------------------
# DecSPC (Algorithms 4, 5 and 6).
# --------------------------------------------------------------------------
def _srr_search(
    g: RefGraph, idx: RefSPCIndex, a: int, b: int, l_ab: Set[int]
) -> Tuple[Set[int], Set[int]]:
    """Algorithm 5: compute SR_a and R_a (run before the edge is removed)."""
    sr: Set[int] = set()
    r: Set[int] = set()
    dist = {a: 0}
    cnt = {a: 1}
    q = collections.deque([a])
    while q:
        v = q.popleft()
        d, c = idx.query(v, b)
        if dist[v] + 1 != d:
            continue  # v has no shortest path through (a, b)
        if v in l_ab or cnt[v] == c:
            sr.add(v)
        else:
            r.add(v)
        for w in g.adj[v]:
            if w not in dist:
                dist[w] = dist[v] + 1
                cnt[w] = cnt[v]
                q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]
    return sr, r


def _dec_update(
    g: RefGraph, idx: RefSPCIndex, h: int, sr: Set[int], r: Set[int], h_ab: bool
) -> None:
    """Algorithm 6: BFS from affected hub h over the post-deletion graph."""
    affected = sr | r
    dist = {h: 0}
    cnt = {h: 1}
    updated: Set[int] = set()
    q = collections.deque([h])
    while q:
        v = q.popleft()
        d_bar, _ = idx.prequery(h, v)
        if d_bar < dist[v]:
            continue
        if v in affected:
            old = idx.get(v, h)
            if old is None:
                idx.insert(v, (h, dist[v], cnt[v]))
            else:
                _, d, c = old
                if d != dist[v] or c != cnt[v]:
                    idx.insert(v, (h, dist[v], cnt[v]))
            updated.add(v)
        for w in g.adj[v]:
            if w not in dist:
                if h <= w:
                    dist[w] = dist[v] + 1
                    cnt[w] = cnt[v]
                    q.append(w)
            elif dist[w] == dist[v] + 1:
                cnt[w] += cnt[v]
    if h_ab:
        for u in affected:
            if u not in updated and idx.get(u, h) is not None:
                idx.remove(u, h)


def dec_spc(g: RefGraph, idx: RefSPCIndex, a: int, b: int) -> None:
    """Algorithm 4: maintain the index after deleting edge (a, b).

    Mutates ``g`` (removing the edge) and ``idx`` in place.  Applies the
    isolated-vertex optimization of Section 3.2.3 when possible.
    """
    if not g.has_edge(a, b):
        raise ValueError(f"edge ({a},{b}) not present")

    # ---- isolated-vertex optimization (S 3.2.3) -------------------------
    # Let b' be a degree-1 endpoint with *lower* rank (larger id) than the
    # other endpoint: after deletion it is isolated and, by rank order, it
    # never appears as a hub in any other label set.
    lo, hi = (a, b) if a < b else (b, a)  # hi has lower rank
    if g.degree(hi) == 1:
        g.remove_edge(a, b)
        idx.labels[hi] = [(hi, 0, 1)]
        return

    l_ab = set(idx.hubs(a)) & set(idx.hubs(b))
    sr_a, r_a = _srr_search(g, idx, a, b, l_ab)
    sr_b, r_b = _srr_search(g, idx, b, a, l_ab)
    g.remove_edge(a, b)
    for h in sorted(sr_a | sr_b):  # descending rank
        if h in sr_a:
            _dec_update(g, idx, h, sr_b, r_b, h in l_ab)
        else:
            _dec_update(g, idx, h, sr_a, r_a, h in l_ab)


def srr_sets(
    g: RefGraph, idx: RefSPCIndex, a: int, b: int
) -> Tuple[Set[int], Set[int], Set[int], Set[int]]:
    """Expose (SR_a, SR_b, R_a, R_b) for the Table-5 benchmark."""
    l_ab = set(idx.hubs(a)) & set(idx.hubs(b))
    sr_a, r_a = _srr_search(g, idx, a, b, l_ab)
    sr_b, r_b = _srr_search(g, idx, b, a, l_ab)
    return sr_a, sr_b, r_a, r_b


# --------------------------------------------------------------------------
# Vertex-level events (Section 3: reduce to edge events).
# --------------------------------------------------------------------------
def insert_vertex(g: RefGraph, idx: RefSPCIndex) -> int:
    v = g.add_vertex()
    idx.add_vertex()
    idx.insert(v, (v, 0, 1))
    return v


def delete_vertex(g: RefGraph, idx: RefSPCIndex, v: int) -> None:
    for u in sorted(g.adj[v]):
        dec_spc(g, idx, v, u)


# --------------------------------------------------------------------------
# Validation helper: ESPC check of an index against the BFS oracle.
# --------------------------------------------------------------------------
def check_espc(
    g: RefGraph,
    idx: RefSPCIndex,
    pairs: Sequence[Tuple[int, int]] | None = None,
) -> None:
    """Assert the index answers (dist, count) exactly like BFS counting.

    With ``pairs=None`` checks *all* pairs (use on small graphs only).
    """
    sources = sorted({s for s, _ in pairs} if pairs is not None else range(g.n))
    truth = {s: bfs_spc(g, s) for s in sources}
    if pairs is None:
        pairs = [(s, t) for s in range(g.n) for t in range(g.n)]
    for s, t in pairs:
        dist, cnt = truth[s]
        d_true = int(dist[t]) if dist[t] < INF else INF
        c_true = int(cnt[t])
        d_idx, c_idx = idx.query(s, t)
        assert (d_idx, c_idx) == (d_true, c_true), (
            f"query({s},{t}) = ({d_idx},{c_idx}), oracle = ({d_true},{c_true})"
        )
