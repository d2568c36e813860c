"""Unified SPC query-serving engine (the DSPC read hot path).

Port of ``repro.serve.engine``:

1. **Validate on the host.**  Ids are bounds-checked as numpy arrays
   on their natural dtype before anything reaches the device (a torch
   gather would raise deep inside a kernel, or answer for a wrong
   vertex after a narrowing cast).
2. **Bucket-pad.**  Batches are padded to ``DEFAULT_BUCKETS`` with
   dump-row pairs ``(n, n)``, which evaluate to ``(INF, 0)`` and are
   sliced off, so every route sees a few static batch shapes.
3. **Route.**  Per batch:

   ========  ===========================================  ===========
   route     when                                         counts
   ========  ===========================================  ===========
   kernel    ``auto`` on a CUDA index, or explicit        int64 exact
   merge     ``auto`` on a CPU index, or explicit         int64 exact
   table     explicit only (the O(L^2) arithmetic of the  int64 exact
             TPU kernel in plain torch)
   ========  ===========================================  ===========

   The TPU engine partitions kernel batches by a 2^24 count bound
   because its kernel counts in fp32; the CUDA kernel counts in int64,
   so the kernel route takes every row and records plain ``kernel``.

4. **Refresh.**  :meth:`QueryEngine.serve_from` serves from a
   ``SnapshotStore``: each batch pins one published (version, index)
   snapshot, and per-version query counts land in ``stats.versions``.

5. **Shard.**  :meth:`QueryEngine.sharded` wraps
   ``repro_torch.core.distributed.make_sharded_query`` (the index
   replicated once per distinct device of a serving mesh, the batch
   split over its batch axes, the merge core on each shard) with the
   same pad-and-slice handling, so mesh replicas serve any batch size.

The engine is stateless with respect to the index (pass it per call)
and stateful only in its route and counters, so one engine can front
many reader threads; every thread launches on the current stream of
the index's device, so a reader never reads a snapshot's rows on
another stream than the one that wrote them.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.analysis.shadow import assert_no_locks_held, make_lock
from repro_torch.core import query as Q
from repro_torch.core.labels import SPCIndex
from repro_torch.kernels.spc_query.ops import exact_query_batch
from repro_torch.serve.routing import RoutePolicy

#: Static batch shapes.  Batches larger than the last bucket are padded
#: to the next multiple of it.
DEFAULT_BUCKETS = (8, 64, 256, 1024)


def bucket_size(b: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= b (multiples of the largest bucket beyond)."""
    for cap in buckets:
        if b <= cap:
            return cap
    top = buckets[-1]
    return -(-b // top) * top


def coalesce_pairs(parts):
    """Assemble per-request ``(s, t)`` pair lists into one flat batch.

    Returns ``(s, t, offsets)``; ``offsets[i]:offsets[i + 1]`` spans
    part ``i`` (the mapping :func:`split_rows` inverts).  Ids keep their
    natural dtype so the engine's bounds check sees un-wrapped values.
    """
    ss, ts, offsets = [], [], [0]
    for k, (s, t) in enumerate(parts):
        s = np.asarray(s).reshape(-1)
        t = np.asarray(t).reshape(-1)
        if s.shape != t.shape:
            raise ValueError(
                f"part {k}: s/t shape mismatch: {s.shape} vs {t.shape}")
        ss.append(s)
        ts.append(t)
        offsets.append(offsets[-1] + s.shape[0])
    if not ss:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.zeros(1, np.int64))
    return (np.concatenate(ss), np.concatenate(ts),
            np.asarray(offsets, np.int64))


def split_rows(d, c, offsets):
    """Scatter a coalesced batch's answers back per request (the inverse
    of :func:`coalesce_pairs`): a list of ``(dist_i, cnt_i)`` numpy
    views, one per part."""
    d = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    c = c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    if d.shape[0] != int(offsets[-1]) or c.shape[0] != int(offsets[-1]):
        raise ValueError(
            f"answers of {d.shape[0]}/{c.shape[0]} rows do not cover the "
            f"coalesced batch of {int(offsets[-1])} pairs")
    return [(d[int(offsets[i]):int(offsets[i + 1])],
             c[int(offsets[i]):int(offsets[i + 1])])
            for i in range(len(offsets) - 1)]


@dataclasses.dataclass(frozen=True)
class ServeStatsView:
    """Point-in-time frozen copy of a ``ServeStats`` (``snapshot``)."""

    queries: int
    batches: int
    routes: Mapping[str, int]
    versions: Mapping[int, int]


@dataclasses.dataclass
class ServeStats:
    queries: int = 0          # real (un-padded) queries answered
    batches: int = 0          # engine dispatches
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: queries answered per pinned snapshot version (``serve_from`` and
    #: the service's readers)
    versions: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # one engine may front many reader threads; counters must not
        # lose increments to interleaved read-modify-writes
        self._lock = make_lock("serve_stats.lock")

    def count(self, route: str, queries: int) -> None:
        with self._lock:
            self.queries += queries
            self.batches += 1
            self.routes[route] = self.routes.get(route, 0) + 1

    def count_version(self, version: int, queries: int) -> None:
        with self._lock:
            self.versions[version] = self.versions.get(version, 0) + queries

    def snapshot(self) -> ServeStatsView:
        """Lock-guarded frozen copy for cross-thread readers."""
        with self._lock:
            return ServeStatsView(
                queries=self.queries, batches=self.batches,
                routes=types.MappingProxyType(dict(self.routes)),
                versions=types.MappingProxyType(dict(self.versions)))


class QueryEngine:
    """Routed, bucket-padded serving front end over one SPCIndex."""

    def __init__(self, *, route: str | RoutePolicy = "auto",
                 buckets=DEFAULT_BUCKETS) -> None:
        self.route = RoutePolicy.coerce(route).engine_route
        self.buckets = tuple(buckets)
        self.stats = ServeStats()

    @staticmethod
    def _single_device_route(route) -> str:
        """A per-call route for the single-device path; a policy that
        needs a mesh must bind through :meth:`sharded`."""
        policy = RoutePolicy.coerce(route)
        if policy.needs_mesh:
            raise ValueError(
                "sharded RoutePolicy cannot be evaluated on the "
                "single-device query path; bind it through "
                "QueryEngine.sharded(mesh) or SPCService.reader")
        return policy.engine_route

    @staticmethod
    def _validate_ids(n: int, s: np.ndarray, t: np.ndarray) -> None:
        """Host-side bounds check of the query ids."""
        for arr in (s, t):
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                bad = arr[(arr < 0) | (arr >= n)][0]
                raise ValueError(
                    f"vertex id {int(bad)} out of range [0, {n})")

    def query_batch(self, idx: SPCIndex, s, t, route=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Answer B (s, t) pairs: (dist int32[B], count int64[B]) on the
        index's device."""
        s = np.asarray(s).reshape(-1)  # validate on the natural dtype
        t = np.asarray(t).reshape(-1)
        if s.shape != t.shape:
            raise ValueError(f"s/t shape mismatch: {s.shape} vs {t.shape}")
        route = (self._single_device_route(route) if route is not None
                 else self.route)
        self._validate_ids(idx.n, s, t)
        assert_no_locks_held("QueryEngine.query_batch")
        b = s.shape[0]
        if b == 0:
            # no dispatch and no phantom batch of 0 queries in the stats
            return (torch.empty(0, dtype=torch.int32, device=idx.device),
                    torch.empty(0, dtype=torch.int64, device=idx.device))
        pad = bucket_size(b, self.buckets) - b
        ids = np.full((2, b + pad), idx.n, dtype=np.int64)  # dump-row pads
        ids[0, :b] = s
        ids[1, :b] = t
        ids = torch.from_numpy(ids).to(idx.device)  # one host-to-device copy
        if route == "auto":
            route = "kernel" if idx.device.type == "cuda" else "merge"
        if route == "kernel":
            d, c = exact_query_batch(idx, ids[0], ids[1])
        elif route == "merge":
            d, c = Q.batched_query_merge(idx, ids[0], ids[1])
        else:
            d, c = Q.batched_query(idx, ids[0], ids[1])
        self.stats.count(route, b)
        return d[:b], c[:b]

    def query_pair(self, idx: SPCIndex, s: int, t: int) -> Tuple[int, int]:
        """Single (s, t) query through the same bucketed batch path."""
        d, c = self.query_batch(idx, [s], [t])
        return int(d[0]), int(c[0])

    # -- multi-device serving ----------------------------------------------
    def sharded(self, mesh, batch_axes: Tuple[str, ...] = ("data",)):
        """Serving closure over replicated-index / batch-sharded replicas
        (``src/repro/serve/engine.py:308``).

        Returns ``serve(idx, s, t, route=None) -> (dist[B], cnt[B])``;
        batches are padded with dump-row pairs ``(n, n)`` to a bucket
        that divides over the mesh axes, so callers keep any batch size.
        Only the merge core is sharded: a route other than ``auto`` /
        ``merge`` (per call, or the engine's own) raises.
        """
        from repro_torch.core.distributed import make_sharded_query

        fn = make_sharded_query(mesh, batch_axes)
        shards = 1
        for ax in batch_axes:
            shards *= mesh.shape[ax]
        axes = "x".join(batch_axes)

        def serve(idx: SPCIndex, s, t, route=None):
            s = np.asarray(s).reshape(-1)
            t = np.asarray(t).reshape(-1)
            if s.shape != t.shape:
                raise ValueError(
                    f"s/t shape mismatch: {s.shape} vs {t.shape}")
            route_ = (RoutePolicy.coerce(route).engine_route
                      if route is not None else self.route)
            if route_ not in ("auto", "merge"):
                raise ValueError(
                    f"route {route_!r} is not available on the sharded "
                    f"serving path (only the sorted-merge core is "
                    f"sharded); use route='auto' or 'merge'")
            self._validate_ids(idx.n, s, t)
            assert_no_locks_held("QueryEngine.sharded.serve")
            b = s.shape[0]
            if b == 0:  # see query_batch: no dispatch, no phantom batch
                return (torch.empty(0, dtype=torch.int32, device=idx.device),
                        torch.empty(0, dtype=torch.int64, device=idx.device))
            bp = bucket_size(b, self.buckets)
            bp = -(-bp // shards) * shards  # divisible over the mesh axes
            ids = np.full((2, bp), idx.n, dtype=np.int64)  # dump-row pads
            ids[0, :b] = s
            ids[1, :b] = t
            ids = torch.from_numpy(ids)
            d, c = fn(idx, ids[0], ids[1])
            self.stats.count(f"sharded[{axes}]:merge", b)
            return d[:b], c[:b]

        return serve

    def serve_from(self, store, *, mesh=None,
                   batch_axes: Tuple[str, ...] = ("data",)):
        """Serving closure over a ``SnapshotStore``
        (``src/repro/serve/engine.py:363``): each batch pins
        ``store.current()`` for its whole duration, so a concurrent
        publish of version k + 1 never touches a batch answering from
        version k.  Returns ``serve(s, t, route=None) -> (dist[B],
        cnt[B])``; per-version query counts land in ``stats.versions``.
        With ``mesh=`` each batch is answered through :meth:`sharded`
        replicas over ``batch_axes``."""
        inner = self.sharded(mesh, batch_axes) if mesh is not None else None

        def serve(s, t, route=None):
            snap = store.current()  # pinned for the whole batch
            if inner is not None:
                d, c = inner(snap.index, s, t, route=route)
            else:
                d, c = self.query_batch(snap.index, s, t, route=route)
            b = int(d.shape[0])
            if b:
                self.stats.count_version(snap.version, b)
            return d, c

        return serve
