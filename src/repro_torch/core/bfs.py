"""Level-synchronous SPC-counting BFS over the edge list (torch).

Port of ``repro.core.bfs``.  One BFS level is one relaxation of the
edge list:

    contribution[w] = sum over edges (v, w) with v in frontier of cnt[v]

an int64 ``index_add_`` keyed by edge destination.  Integer atomics
are order-independent, so results are deterministic on the card.

The reference runs each BFS inside one ``lax.while_loop``.  Eager
torch has no device-side loop, so each BFS here is a host loop that
reads ``frontier.any()`` once per level: one host sync per level,
counted in :data:`frontier_syncs` (the first suspect for later work:
a CUDA graph or an on-device loop removes it).

Only the first ``g.m2`` edge slots are relaxed: slots past the
high-water mark are all pads that relax into the dump row, which no
result reads, and on the card thousands of their atomics would
contend on that one row.

The relaxation primitive stays pluggable (``RelaxFn`` /
``MultiRelaxFn``), as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.graph import INF, Graph

#: ``relax_fn(src, dst, cnt, frontier) -> int64[n + 1]``.
RelaxFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]

#: ``multi_relax_fn(src, dst, cnt, frontier) -> int64[B, n + 1]``: ``cnt``
#: and ``frontier`` carry a leading hub-batch axis.
MultiRelaxFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class SyncCounter:
    """A plain count of host syncs taken by the BFS level loops."""

    def __init__(self) -> None:
        self.count = 0


#: One per ``frontier.any()`` read (one per BFS level, plus the read
#: that finds the frontier empty).  Callers reset it to 0 and read it
#: around the work they measure.
frontier_syncs = SyncCounter()


def _frontier_live(frontier: torch.Tensor) -> bool:
    frontier_syncs.count += 1
    return bool(frontier.any())


class BFSResult(NamedTuple):
    dist: torch.Tensor   # int32[n + 1] (INF where unreached)
    cnt: torch.Tensor    # int64[n + 1]
    keep: torch.Tensor   # bool[n + 1]: visited AND not pruned
    levels: int          # number of relaxation rounds executed


class MultiBFSResult(NamedTuple):
    dist: torch.Tensor   # int32[B, n + 1]
    cnt: torch.Tensor    # int64[B, n + 1]
    keep: torch.Tensor   # bool[B, n + 1]
    levels: int          # rounds until EVERY BFS drained


def compress_frontier(cnt: torch.Tensor, frontier: torch.Tensor):
    """Fuse (frontier, cnt) into one masked-count operand."""
    return torch.where(frontier, cnt, 0)


def edge_relax(src, dst, cnt, frontier) -> torch.Tensor:
    """Per-destination sums of frontier counts, int64[n + 1]."""
    contrib = torch.index_select(compress_frontier(cnt, frontier), 0, src)
    return torch.zeros_like(cnt).index_add_(0, dst, contrib)


def multi_edge_relax(src, dst, cnt, frontier) -> torch.Tensor:
    """One edge relaxation of B independent BFS: int64[B, n + 1] sums."""
    contrib = torch.index_select(compress_frontier(cnt, frontier), 1, src)
    return torch.zeros_like(cnt).index_add_(1, dst, contrib)


def _live_edges(g: Graph):
    return g.src[:g.m2], g.dst[:g.m2]


def pruned_spc_bfs(g: Graph, root: int, root_dist, root_cnt, dbar,
                   rank_floor: int | None = None,
                   max_levels: int | None = None,
                   relax_fn: RelaxFn | None = None) -> BFSResult:
    """Pruned counting BFS used by construction, IncSPC and DecSPC.

    ``root_dist`` / ``root_cnt`` may be ints or 0-d device tensors (the
    IncSPC seed is read off the index without a sync); ``dbar`` is the
    int32[n + 1] pruning distance, ``rank_floor`` the paper's rank
    pruning (only ids >= rank_floor may be discovered).
    """
    if relax_fn is None:
        relax_fn = edge_relax
    dev = g.device
    n1 = g.n + 1
    src, dst = _live_edges(g)
    ids = torch.arange(n1, dtype=torch.int32, device=dev)
    eligible = ids < g.n
    if rank_floor is not None:
        eligible &= ids >= rank_floor
    root_dist = torch.as_tensor(root_dist, dtype=torch.int32, device=dev)
    root_cnt = torch.as_tensor(root_cnt, dtype=torch.int64, device=dev)
    at_root = ids == root
    dist = torch.where(at_root, root_dist, INF)
    cnt = torch.where(at_root, root_cnt, 0)
    frontier = at_root & (dbar[root] >= root_dist)
    keep = frontier
    level = root_dist
    if max_levels is None:
        max_levels = g.n
    rounds = 0
    while rounds < max_levels and _frontier_live(frontier):
        sums = relax_fn(src, dst, cnt, frontier)
        newly = (sums > 0) & (dist == INF) & eligible
        dist = torch.where(newly, level + 1, dist)
        cnt = torch.where(newly, sums, cnt)
        frontier = newly & ~(dbar < dist)
        keep = keep | frontier
        level = level + 1
        rounds += 1
    return BFSResult(dist=dist, cnt=cnt, keep=keep, levels=rounds)


def multi_pruned_spc_bfs(g: Graph, roots: torch.Tensor, dbar: torch.Tensor,
                         rank_floor: bool = True,
                         batch_rank_prune: bool = True,
                         max_levels: int | None = None,
                         multi_relax_fn: MultiRelaxFn | None = None
                         ) -> MultiBFSResult:
    """B pruned counting BFS advanced in lockstep (PSPC-style batching).

    ``roots`` int32[B] ascending; a root >= n marks an inactive lane.
    ``dbar`` int32[B, n + 1] committed pruning distances.  With
    ``batch_rank_prune`` a vertex newly discovered by lane b at distance
    d is also pruned if an earlier lane b' < b kept both roots[b] and
    the vertex with ``dist_b'[roots[b]] + dist_b'[w] < d`` -- the
    [B, B, n + 1] int32 minimum of the reference, evaluated on the
    pre-level state.
    """
    if multi_relax_fn is None:
        multi_relax_fn = multi_edge_relax
    dev = g.device
    n1 = g.n + 1
    src, dst = _live_edges(g)
    roots = roots.to(device=dev, dtype=torch.int32)
    b = roots.shape[0]
    ids = torch.arange(n1, dtype=torch.int32, device=dev)
    valid = roots < g.n
    roots_c = torch.clamp(roots, max=g.n).long()
    eligible = (ids[None, :] < g.n).expand(b, n1)
    if rank_floor:
        eligible = eligible & (ids[None, :] >= roots[:, None])
    at_root = (ids[None, :] == roots[:, None]) & valid[:, None]
    dist = torch.where(at_root, 0, torch.full_like(at_root, INF,
                                                   dtype=torch.int32))
    cnt = at_root.to(torch.int64)
    frontier = at_root & (dbar.gather(1, roots_c[:, None]) >= 0)
    keep = frontier
    if max_levels is None:
        max_levels = g.n
    lane = torch.arange(b, device=dev)
    earlier = lane[:, None] < lane[None, :]
    rounds = 0
    while rounds < max_levels and _frontier_live(frontier):
        sums = multi_relax_fn(src, dst, cnt, frontier)
        newly = (sums > 0) & (dist == INF) & eligible
        d_new = rounds + 1
        pruned = newly & (dbar < d_new)
        if batch_rank_prune:
            hub_d = dist[:, roots_c]                          # [B', B]
            hub_ok = keep[:, roots_c] & earlier
            a = torch.where(hub_ok, hub_d, INF)
            dm = torch.where(keep, dist, INF)                 # [B', n+1]
            dbar_in = (a[:, :, None] + dm[:, None, :]).amin(dim=0)
            pruned = pruned | (newly & (dbar_in < d_new))
        dist = torch.where(newly, d_new, dist)
        cnt = torch.where(newly, sums, cnt)
        frontier = newly & ~pruned
        keep = keep | frontier
        rounds += 1
    return MultiBFSResult(dist=dist, cnt=cnt, keep=keep, levels=rounds)


def plain_spc_bfs(g: Graph, root: int,
                  max_levels: int | None = None) -> BFSResult:
    """Unpruned counting BFS (the online baseline; also the test oracle)."""
    no_prune = torch.full((g.n + 1,), INF, dtype=torch.int32,
                          device=g.device)
    return pruned_spc_bfs(g, root, 0, 1, dbar=no_prune,
                          max_levels=max_levels)


def conditional_spc_bfs(g: Graph, root: int, stop_mask_fn,
                        max_levels: int | None = None,
                        relax_fn: RelaxFn | None = None) -> BFSResult:
    """BFS whose expansion stops at vertices failing ``stop_mask_fn``
    (``stop_mask_fn(dist, cnt, newly) -> bool[n + 1]``: the vertices
    that may continue).  Used by SRRSearch."""
    if relax_fn is None:
        relax_fn = edge_relax
    dev = g.device
    n1 = g.n + 1
    src, dst = _live_edges(g)
    ids = torch.arange(n1, dtype=torch.int32, device=dev)
    eligible = ids < g.n
    newly0 = ids == root
    dist = torch.where(newly0, 0, torch.full((n1,), INF, dtype=torch.int32,
                                             device=dev))
    cnt = newly0.to(torch.int64)
    frontier = newly0 & stop_mask_fn(dist, cnt, newly0)
    if max_levels is None:
        max_levels = g.n
    rounds = 0
    while rounds < max_levels and _frontier_live(frontier):
        sums = relax_fn(src, dst, cnt, frontier)
        newly = (sums > 0) & (dist == INF) & eligible
        dist = torch.where(newly, rounds + 1, dist)
        cnt = torch.where(newly, sums, cnt)
        frontier = newly & stop_mask_fn(dist, cnt, newly)
        rounds += 1
    return BFSResult(dist=dist, cnt=cnt, keep=dist < INF, levels=rounds)
