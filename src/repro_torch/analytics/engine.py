"""AnalyticsEngine: the analytics layer's one entry point.

Port of ``repro.analytics.engine``.  Every computation answers from
exactly ONE pinned published snapshot: :meth:`AnalyticsEngine.pin`
takes ``store.current()`` and hands back a :class:`PinnedAnalytics`
view whose methods read that snapshot and nothing else.  Only the
store is consulted, never the updater (``DynamicSPC``).

Knob defaults come from the port's ``configs/dspc.py``
(``analytics_*``) through :meth:`AnalyticsEngine.from_config`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.analytics.betweenness import (DEFAULT_V_BLOCK,
                                               TopKBetweenness,
                                               betweenness as _betweenness)
from repro_torch.analytics.cycles import (CycleCount, cycles_through_edge,
                                          cycles_through_vertex)
from repro_torch.analytics.recommend import (common_neighbor_ids, recommend,
                                             recommendation_features)


class PinnedAnalytics:
    """Analytics over ONE immutable snapshot: results are reproducible
    for the lifetime of the handle whatever the updater publishes
    meanwhile; ``version`` says which published index answered."""

    def __init__(self, snapshot, *, v_block: int, top_k: int) -> None:
        self._snapshot = snapshot
        self._v_block = int(v_block)
        self._top_k = int(top_k)

    @property
    def version(self) -> int:
        return self._snapshot.version

    @property
    def index(self):
        return self._snapshot.index

    @property
    def n(self) -> int:
        return self._snapshot.index.n

    # -- betweenness --------------------------------------------------------
    def betweenness(self, *, pairs=None, vertices=None) -> np.ndarray:
        return _betweenness(self.index, pairs=pairs, vertices=vertices,
                            v_block=self._v_block)

    def top_betweenness(self, k: Optional[int] = None, *, pairs=None):
        """[(vertex, score)] by score desc, id asc."""
        k = self._top_k if k is None else int(k)
        scores = self.betweenness(pairs=pairs)
        order = np.lexsort((np.arange(scores.shape[0]), -scores))[:k]
        return [(int(i), float(scores[i])) for i in order]

    # -- cycles -------------------------------------------------------------
    def cycles_through_vertex(self, v: int) -> CycleCount:
        return cycles_through_vertex(self.index, v)

    def cycles_through_edge(self, a: int, b: int) -> CycleCount:
        return cycles_through_edge(self.index, a, b)

    # -- recommendation -----------------------------------------------------
    def recommend(self, u: int, k: Optional[int] = None):
        return recommend(self.index, u,
                         k=self._top_k if k is None else int(k))

    def recommendation_features(self, u: int,
                                candidates: np.ndarray) -> np.ndarray:
        return recommendation_features(self.index, u, candidates)

    def common_neighbor_ids(self, u: int, x: int) -> np.ndarray:
        return common_neighbor_ids(self.index, u, x)


class AnalyticsEngine:
    """Stateless front: pins a fresh snapshot per computation.

    ``source`` is a ``SnapshotStore`` (or anything with a ``store``
    attribute holding one); only ``store.current()`` is ever read.
    """

    def __init__(self, source, *, pair_sample: int = 512,
                 top_k: int = 16, seed: int = 0,
                 v_block: int = DEFAULT_V_BLOCK) -> None:
        self._store = getattr(source, "store", source)
        if not hasattr(self._store, "current"):
            raise TypeError(
                f"AnalyticsEngine needs a SnapshotStore, got "
                f"{type(source).__name__}")
        self.pair_sample = int(pair_sample)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.v_block = int(v_block)

    @classmethod
    def from_config(cls, source, config) -> "AnalyticsEngine":
        """Build with the ``analytics_*`` knobs of a
        ``configs/dspc.py`` config shape."""
        return cls(source,
                   pair_sample=getattr(config, "analytics_pair_sample", 512),
                   top_k=getattr(config, "analytics_top_k", 16),
                   v_block=getattr(config, "analytics_v_block",
                                   DEFAULT_V_BLOCK))

    # -- snapshot pinning ---------------------------------------------------
    def pin(self) -> PinnedAnalytics:
        """Pin the newest published snapshot for a batch of analytics."""
        return PinnedAnalytics(self._store.current(), v_block=self.v_block,
                               top_k=self.top_k)

    @property
    def store(self):
        return self._store

    # -- workloads ----------------------------------------------------------
    def sample_pairs(self, n_pairs: Optional[int] = None,
                     seed: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """A reproducible (s, t) workload: distinct ordered pairs,
        uniform over the pinned snapshot's vertex set (the reference's
        numpy draw, so both packages sample the same pairs)."""
        n = self.pin().n
        n_pairs = self.pair_sample if n_pairs is None else int(n_pairs)
        n_pairs = min(n_pairs, n * (n - 1)) if n > 1 else 0
        rng = np.random.default_rng(self.seed if seed is None else seed)
        seen = set()
        s_out, t_out = [], []
        while len(s_out) < n_pairs:
            s, t = (int(x) for x in rng.integers(0, n, size=2))
            if s == t or (s, t) in seen:
                continue
            seen.add((s, t))
            s_out.append(s)
            t_out.append(t)
        return (np.asarray(s_out, dtype=np.int32),
                np.asarray(t_out, dtype=np.int32))

    def betweenness_maintainer(self, pairs=None, *, vertices=None,
                               k: Optional[int] = None,
                               **kw) -> TopKBetweenness:
        """An incrementally refreshed top-k betweenness view over this
        store's publish stream."""
        if pairs is None:
            pairs = self.sample_pairs()
        return TopKBetweenness(
            self._store, pairs, vertices=vertices,
            k=self.top_k if k is None else int(k),
            v_block=self.v_block, **kw)

    # -- one-shot conveniences (each pins a fresh snapshot) -----------------
    def betweenness(self, **kw) -> np.ndarray:
        return self.pin().betweenness(**kw)

    def top_betweenness(self, k: Optional[int] = None, **kw):
        return self.pin().top_betweenness(k, **kw)

    def cycles_through_vertex(self, v: int) -> CycleCount:
        return self.pin().cycles_through_vertex(v)

    def cycles_through_edge(self, a: int, b: int) -> CycleCount:
        return self.pin().cycles_through_edge(a, b)

    def recommend(self, u: int, k: Optional[int] = None):
        return self.pin().recommend(u, k)
