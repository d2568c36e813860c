"""Top-k friend recommendation from SPC-count features.

Port of ``repro.analytics.recommend``.  For a user ``u`` the
common-friend count with a non-friend ``x`` is ``sigma(u, x)`` whenever
``d(u, x) == 2``, so one ``one_to_all`` row over the pinned snapshot
yields the candidate set (every vertex at distance 2) and its ranking
signal at once; no adjacency structure is consulted.

:func:`recommendation_features` gives per-candidate feature rows
``[d(u, x), sigma(u, x), size[x], cnt_sum[x]]`` (float32) off the same
snapshot; :func:`common_neighbor_ids` recovers the common-friend ids
from two one_to_all rows.  :func:`recommend_numpy` is the adjacency-set
oracle (no index).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core import query as Q
from repro_torch.core.graph import INF
from repro_torch.core.labels import SPCIndex


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """One ranked candidate: ``score`` is the common-friend count
    (sigma at distance 2)."""
    vertex: int
    score: int
    dist: int


def _one_to_all(idx: SPCIndex, u: int):
    """Host (dist int32[n + 1], cnt int64[n + 1]) of one_to_all(u)."""
    dist, cnt = Q.one_to_all(idx, int(u))
    return dist.cpu().numpy(), cnt.cpu().numpy()


def recommend(idx: SPCIndex, u: int, *, k: int = 16) -> List[Recommendation]:
    """Top-k friends-of-friends of ``u`` by common-friend count,
    deterministically tie-broken by vertex id."""
    dist, cnt = _one_to_all(idx, u)
    dist, cnt = dist[:idx.n], cnt[:idx.n]
    cand = np.flatnonzero(dist == 2)
    if cand.size == 0:
        return []
    order = np.lexsort((cand, -cnt[cand]))[:k]
    return [Recommendation(int(cand[i]), int(cnt[cand[i]]), 2)
            for i in order]


def recommendation_features(idx: SPCIndex, u: int,
                            candidates: np.ndarray) -> np.ndarray:
    """float32 [C, 4] feature rows ``[dist, sigma, size, cnt_sum]``
    for ``candidates``, all off the pinned snapshot (disconnected
    candidates get dist = -1, sigma = 0)."""
    dist, cnt = _one_to_all(idx, u)
    c = np.asarray(candidates, dtype=np.int64)
    d = dist[c].astype(np.float32)
    d[dist[c] >= INF] = -1.0
    return np.stack(
        [d,
         cnt[c].astype(np.float32),
         idx.size.cpu().numpy()[c].astype(np.float32),
         idx.cnt_sum.cpu().numpy()[c].astype(np.float32)],
        axis=1)


def common_neighbor_ids(idx: SPCIndex, u: int, x: int) -> np.ndarray:
    """Ids of the common friends of ``u`` and ``x`` (for embedding-bag
    pooling), recovered from two one_to_all rows."""
    du = Q.one_to_all_dist(idx, int(u))[:idx.n]
    dx = Q.one_to_all_dist(idx, int(x))[:idx.n]
    return ((du == 1) & (dx == 1)).nonzero()[:, 0].cpu().numpy()


def recommend_numpy(n: int, edges, u: int, *,
                    k: int = 16) -> List[Recommendation]:
    """Brute-force oracle: common-friend counts from adjacency sets."""
    adj = [set() for _ in range(n)]
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    scores = {}
    for x in range(n):
        if x == u or x in adj[u]:
            continue
        common = len(adj[u] & adj[x])
        if common:
            scores[x] = common
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [Recommendation(x, s, 2) for x, s in ranked]
