"""Betweenness centrality from SPC counts (pair-dependency accumulation).

Port of ``repro.analytics.betweenness``.  Brandes' pair dependency

    delta(s, t | v) = sigma_sv * sigma_vt / sigma_st
                      when  d(s, v) + d(v, t) == d(s, t),  v not in {s, t}

accumulated over a workload of ordered pairs is the betweenness
``BC(v)``.  :class:`TopKBetweenness` maintains it across published
snapshots, re-scoring only what :func:`changed_rows` says an update
touched (Pontecorvi & Ramachandran's fully dynamic route).

How the cells are evaluated differs from the reference, with the same
integers.  The reference merges the label rows of s, t and v for every
(pair, candidate) cell; at a realistic workload (512 pairs x 65536
candidates) that would move terabytes of gathered rows.  Here each
distinct pair endpoint gets one ``one_to_all`` row (dist and sigma to
every vertex; the index is symmetric, so ``d(v, t) = d(t, v)``), and one
elementwise float64 pass per candidate tile finishes the job.  sigma
values are the same exact int64 as the reference's merges; only the
order of the float64 summation over pairs differs.

Dependencies are accumulated in float64 and ``1 / sigma_st`` is a
float64 reciprocal, as in the reference (which runs with x64 enabled).

:func:`betweenness_numpy` is the BFS oracle (the port's own counting
BFS on the raw edge list, no labels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.shadow import assert_no_locks_held, make_lock
from repro_torch.core import graph as G
from repro_torch.core import query as Q
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.graph import INF
from repro_torch.core.labels import SPCIndex

#: Candidates scored in one elementwise pass (the width of a candidate
#: tile; ``configs/dspc.py`` ``analytics_v_block``).
DEFAULT_V_BLOCK = 256

#: Pairs whose endpoint rows are held at once: at most 2 * 512 rows of
#: n + 1 (int32 dist + int64 sigma), 0.8 GB at n = 65536.
_PAIR_BLOCK = 512


def _endpoint_rows(idx: SPCIndex, ends: torch.Tensor):
    """one_to_all rows of the endpoints ``ends``: dist int32 [E, n + 1],
    sigma int64 [E, n + 1]."""
    rows = [Q.one_to_all(idx, int(e)) for e in ends.tolist()]
    if not rows:
        return (torch.empty((0, idx.n + 1), dtype=torch.int32,
                            device=idx.device),
                torch.empty((0, idx.n + 1), dtype=torch.int64,
                            device=idx.device))
    return (torch.stack([d for d, _ in rows]),
            torch.stack([c for _, c in rows]))


def _dependency_block(dist: torch.Tensor, cnt: torch.Tensor,
                      si: torch.Tensor, ti: torch.Tensor, s: torch.Tensor,
                      t: torch.Tensor, vs: torch.Tensor,
                      n: int) -> torch.Tensor:
    """sum over pairs b of delta(s_b, t_b | v) for every v in ``vs`` ->
    float64 [V].

    ``dist``/``cnt`` are the endpoint rows; ``si``/``ti`` [B] the rows
    of s and t in them; ``vs`` [V] candidate ids (ids >= n are masked).
    """
    d_st = dist[si, t]
    c_st = cnt[si, t]
    inv_st = torch.where(c_st > 0, 1.0 / c_st.to(torch.float64), 0.0)
    vc = vs.clamp(max=n)[None, :]
    d_sv, c_sv = dist[si[:, None], vc], cnt[si[:, None], vc]
    d_vt, c_vt = dist[ti[:, None], vc], cnt[ti[:, None], vc]
    # INF + INF stays int32-safe and never equals a finite d_st
    on = ((d_st < INF)[:, None]
          & (d_sv + d_vt == d_st[:, None])
          & (vs[None, :] != s[:, None]) & (vs[None, :] != t[:, None])
          & (vs < n)[None, :])
    num = c_sv.to(torch.float64) * c_vt.to(torch.float64)
    return torch.where(on, num * inv_st[:, None], 0.0).sum(dim=0)


def _accumulate(out: torch.Tensor, rows, si, ti, s, t, verts: torch.Tensor,
                n: int, v_block: int) -> torch.Tensor:
    """``out`` [V] += the dependencies of the pairs (s, t) on ``verts``,
    from endpoint rows ``rows`` = (dist, cnt) indexed by ``si``/``ti``;
    one candidate tile of ``v_block`` at a time."""
    for vlo in range(0, verts.shape[0], v_block):
        out[vlo:vlo + v_block] += _dependency_block(
            *rows, si, ti, s, t, verts[vlo:vlo + v_block], n)
    return out


def dependency_scores(idx: SPCIndex,
                      pairs_s: np.ndarray, pairs_t: np.ndarray,
                      vertices: np.ndarray, *,
                      v_block: int = DEFAULT_V_BLOCK) -> np.ndarray:
    """Accumulated pair dependencies: float64 [len(vertices)]."""
    pairs_s = np.asarray(pairs_s, dtype=np.int64)
    pairs_t = np.asarray(pairs_t, dtype=np.int64)
    vertices = np.asarray(vertices, dtype=np.int64)
    if pairs_s.shape != pairs_t.shape:
        raise ValueError("pairs_s and pairs_t must have equal length")
    n_v = vertices.shape[0]
    if pairs_s.size == 0 or n_v == 0:
        return np.zeros(n_v, dtype=np.float64)
    assert_no_locks_held("dependency_scores")
    dev = idx.device
    verts = torch.as_tensor(vertices, device=dev)
    out = torch.zeros(n_v, dtype=torch.float64, device=dev)
    for lo in range(0, pairs_s.shape[0], _PAIR_BLOCK):
        s = torch.as_tensor(pairs_s[lo:lo + _PAIR_BLOCK], device=dev)
        t = torch.as_tensor(pairs_t[lo:lo + _PAIR_BLOCK], device=dev)
        ends, inv = torch.unique(torch.cat([s, t]), return_inverse=True)
        si, ti = inv[:s.shape[0]], inv[s.shape[0]:]
        _accumulate(out, _endpoint_rows(idx, ends), si, ti, s, t, verts,
                    idx.n, v_block)
    return out.cpu().numpy()


def all_pairs(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every ordered pair (s, t), s != t -- the exact-BC workload."""
    s, t = np.where(~np.eye(n, dtype=bool))
    return s.astype(np.int32), t.astype(np.int32)


def betweenness(idx: SPCIndex, *,
                pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                vertices: Optional[np.ndarray] = None,
                v_block: int = DEFAULT_V_BLOCK) -> np.ndarray:
    """Betweenness over a pair workload (default: exact, all ordered
    pairs) for ``vertices`` (default: all) -- float64 [len(vertices)]."""
    if pairs is None:
        pairs = all_pairs(idx.n)
    if vertices is None:
        vertices = np.arange(idx.n, dtype=np.int32)
    return dependency_scores(idx, pairs[0], pairs[1], vertices,
                             v_block=v_block)


# --------------------------------------------------------------------------
# Affected set: diff two published snapshots at the label-row level.
# --------------------------------------------------------------------------
def changed_rows(old: SPCIndex, new: SPCIndex) -> np.ndarray:
    """bool [n]: vertices whose label row differs between snapshots.

    Rows are compared in storage convention (hub-sorted, pad hub = n /
    dist = INF / cnt = 0), so a pure repad (capacity growth) changes
    nothing.  Computed on the snapshots' device; only the [n] result
    comes to the host.
    """
    if old.n != new.n:
        raise ValueError(
            f"changed_rows requires equal n (got {old.n} vs {new.n}); "
            "vertex insert/delete invalidates the whole score set")
    n = old.n
    common = min(old.l_cap, new.l_cap)
    diff = old.size[:n] != new.size[:n]
    for a, b in ((old.hub, new.hub), (old.dist, new.dist),
                 (old.cnt, new.cnt)):
        diff |= (a[:n, :common] != b[:n, :common]).any(dim=1)
    wide = old if old.l_cap > common else new
    if wide.l_cap > common:   # columns past the narrower one must be pads
        diff |= ((wide.hub[:n, common:] != n)
                 | (wide.dist[:n, common:] != INF)
                 | (wide.cnt[:n, common:] != 0)).any(dim=1)
    return diff.cpu().numpy()


class TopKBetweenness:
    """Incrementally maintained top-k betweenness over a fixed pair
    workload, fed by published snapshots.

    ``store`` is anything with ``.current() -> Snapshot``.  The
    constructor pins one snapshot and scores every candidate;
    :meth:`refresh` pins the newest snapshot and re-scores only

    * candidates in the affected set (:func:`changed_rows`), against
      the full workload, and
    * all candidates against workload pairs whose endpoint rows
      changed, as ``new - old`` contribution deltas off the previously
      pinned snapshot.

    Both come from the ``one_to_all`` rows of the workload's E distinct
    endpoints, which the maintainer keeps for its pinned snapshot (E x
    (n + 1) x 12 bytes on the device: 0.8 GB for 512 sampled pairs at
    n = 65536).  A refresh builds the new snapshot's rows once: the full
    row of each endpoint whose label row changed, and for the others
    only the changed columns (:func:`~repro_torch.core.query.
    one_to_all_cols`), since column v of row e reads only L(e) and L(v).
    The old snapshot's rows are the kept ones, so nothing is built
    twice.

    When the affected fraction exceeds ``full_rescore_frac`` (or n
    changed) it falls back to a full recompute.  Thread contract: any
    number of :meth:`top` / :meth:`scores` readers, ONE refresher; the
    score swap is guarded by ``analytics.lock``, a leaf that is never
    held across device work.  The pinned snapshot and its rows belong to
    the refresher, which publishes the snapshot after the scores, so
    ``version`` never runs ahead of :meth:`scores`.
    """

    def __init__(self, store, pairs: Tuple[np.ndarray, np.ndarray], *,
                 vertices: Optional[np.ndarray] = None, k: int = 16,
                 v_block: int = DEFAULT_V_BLOCK,
                 full_rescore_frac: float = 0.5) -> None:
        self._store = store
        self._pairs_s = np.asarray(pairs[0], dtype=np.int32)
        self._pairs_t = np.asarray(pairs[1], dtype=np.int32)
        self.k = int(k)
        self._v_block = int(v_block)
        self._frac = float(full_rescore_frac)
        self._lock = make_lock("analytics.lock")
        snap = store.current()
        self._vertices = (np.arange(snap.index.n, dtype=np.int32)
                          if vertices is None
                          else np.asarray(vertices, dtype=np.int32))
        dev = snap.index.device
        self._ends = np.unique(np.concatenate([self._pairs_s,
                                               self._pairs_t]))
        self._s = torch.as_tensor(self._pairs_s, device=dev).long()
        self._t = torch.as_tensor(self._pairs_t, device=dev).long()
        self._si = torch.as_tensor(
            np.searchsorted(self._ends, self._pairs_s), device=dev)
        self._ti = torch.as_tensor(
            np.searchsorted(self._ends, self._pairs_t), device=dev)
        self.full_recomputes = 0
        self.incremental_refreshes = 0
        self.last_changed = 0
        # the pinned snapshot and its endpoint rows: written and read by
        # the one refresher only
        self._snap = snap
        self._scores = self._full(snap.index)

    # -- internals ----------------------------------------------------------
    def _dep(self, rows, n: int, sel: Optional[np.ndarray],
             vertices: np.ndarray) -> np.ndarray:
        """Dependencies on ``vertices`` of the workload pairs selected by
        the bool mask ``sel`` (all pairs if None), from endpoint rows."""
        if sel is None:
            sel = np.ones(self._pairs_s.shape[0], dtype=bool)
        dev = rows[0].device
        verts = torch.as_tensor(vertices, device=dev).long()
        out = torch.zeros(verts.shape[0], dtype=torch.float64, device=dev)
        assert_no_locks_held("TopKBetweenness")
        picked = torch.as_tensor(np.flatnonzero(sel), device=dev)
        for lo in range(0, picked.shape[0], _PAIR_BLOCK):
            b = picked[lo:lo + _PAIR_BLOCK]
            _accumulate(out, rows, self._si[b], self._ti[b], self._s[b],
                        self._t[b], verts, n, self._v_block)
        return out.cpu().numpy()

    def _full(self, idx: SPCIndex) -> np.ndarray:
        self.full_recomputes += 1
        ends = torch.as_tensor(self._ends, device=idx.device)
        self._rows = _endpoint_rows(idx, ends)
        return self._dep(self._rows, idx.n, None, self._vertices)

    def _patched_rows(self, idx: SPCIndex, changed: np.ndarray):
        """The endpoint rows on ``idx``, from the kept rows of the pinned
        snapshot and ``changed`` [n], the rows that differ between the
        two: whole rows for changed endpoints, changed columns for the
        rest."""
        dev = idx.device
        dist, cnt = (r.clone() for r in self._rows)
        moved = changed[self._ends]
        cols = torch.as_tensor(np.flatnonzero(changed), device=dev)
        still = torch.as_tensor(np.flatnonzero(~moved), device=dev)
        if still.shape[0] and cols.shape[0]:
            d, c = Q.one_to_all_cols(
                idx, torch.as_tensor(self._ends, device=dev)[still], cols)
            dist[still[:, None], cols[None, :]] = d
            cnt[still[:, None], cols[None, :]] = c
        if moved.any():
            hit = torch.as_tensor(np.flatnonzero(moved), device=dev)
            dist[hit], cnt[hit] = _endpoint_rows(
                idx, torch.as_tensor(self._ends[moved], device=dev))
        return dist, cnt

    # -- readers ------------------------------------------------------------
    @property
    def version(self) -> int:
        """Version of the snapshot the current scores answer from
        (lock-free: ``_snap`` belongs to the one refresher)."""
        return self._snap.version

    def scores(self) -> np.ndarray:
        """A copy of the maintained score vector (aligned with the
        candidate set passed at construction)."""
        with self._lock:
            return self._scores.copy()

    def top(self, k: Optional[int] = None):
        """[(vertex, score)] sorted by score desc, id asc."""
        k = self.k if k is None else int(k)
        with self._lock:
            scores = self._scores
            verts = self._vertices
        order = np.lexsort((verts, -scores))[:k]
        return [(int(verts[i]), float(scores[i])) for i in order]

    # -- the refresher ------------------------------------------------------
    def refresh(self):
        """Catch the scores up to the newest published snapshot and
        return :meth:`top`.  No-op if the version did not move."""
        snap, old_snap = self._store.current(), self._snap
        if snap.version == old_snap.version:
            return self.top()
        with self._lock:
            scores = self._scores.copy()
        old_idx, new_idx = old_snap.index, snap.index
        if new_idx.n != old_idx.n:
            scores = self._full(new_idx)
            self.last_changed = new_idx.n
        else:
            changed = changed_rows(old_idx, new_idx)
            self.last_changed = int(changed.sum())
            if self.last_changed > self._frac * new_idx.n:
                scores = self._full(new_idx)
            else:
                self.incremental_refreshes += 1
                rows = self._patched_rows(new_idx, changed)
                v_changed = changed[self._vertices]
                p_changed = (changed[self._pairs_s]
                             | changed[self._pairs_t])
                if p_changed.any():
                    dep_new = self._dep(rows, new_idx.n, p_changed,
                                        self._vertices)
                    dep_old = self._dep(self._rows, old_idx.n, p_changed,
                                        self._vertices)
                    scores = scores + np.where(v_changed, 0.0,
                                               dep_new - dep_old)
                if v_changed.any():
                    scores[v_changed] = self._dep(
                        rows, new_idx.n, None, self._vertices[v_changed])
                self._rows = rows
        with self._lock:
            self._scores = scores
        self._snap = snap
        return self.top()


# --------------------------------------------------------------------------
# BFS oracle (differential-test target).
# --------------------------------------------------------------------------
def betweenness_numpy(n: int, edges, *,
                      pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                      vertices: Optional[np.ndarray] = None) -> np.ndarray:
    """Brute-force pair-dependency accumulation over BFS counts.

    Same definition as :func:`betweenness` (ordered pairs), computed
    from the port's counting BFS (``plain_spc_bfs``) on the raw edge
    list, on the CPU -- no label index anywhere.
    """
    g = G.from_edges(n, list(edges), device="cpu")
    if pairs is None:
        pairs = all_pairs(n)
    if vertices is None:
        vertices = np.arange(n, dtype=np.int32)
    src = {}
    for u in set(np.concatenate([pairs[0], pairs[1]]).tolist()):
        res = plain_spc_bfs(g, int(u))
        src[u] = (res.dist.numpy().astype(np.int64), res.cnt.numpy())
    vs = np.asarray(vertices, dtype=np.int64)
    bc = np.zeros(vs.shape[0], dtype=np.float64)
    for s, t in zip(np.asarray(pairs[0]).tolist(),
                    np.asarray(pairs[1]).tolist()):
        dist_s, cnt_s = src[s]
        dist_t, cnt_t = src[t]          # sigma symmetric: undirected
        d_st = dist_s[t]
        if d_st >= INF:
            continue
        sigma_st = float(cnt_s[t])
        on = ((dist_s[vs] + dist_t[vs] == d_st)
              & (vs != s) & (vs != t))
        bc += np.where(
            on,
            cnt_s[vs].astype(np.float64) * cnt_t[vs].astype(np.float64)
            / sigma_st,
            0.0)
    return bc
