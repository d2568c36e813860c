"""HP-SPC index construction (Section 2.2) -- sequential and batched.

Port of ``repro.core.construct``:

* :func:`build_index` -- the paper-faithful sequential builder, one hub
  at a time (a host loop over n hubs here; the reference's
  ``fori_loop``).  Kept as the differential oracle.
* :func:`build_index_batched` -- PSPC-style batched construction:
  ``hub_batch`` hubs run their pruned BFS in lockstep
  (:func:`repro_torch.core.bfs.multi_pruned_spc_bfs`) and commit their
  labels in one bulk scatter.  Order-identical to the sequential
  builder.  A round that overflows label capacity is retried from its
  pre-round snapshot with doubled ``l_cap``.

The reference vmaps ``one_to_all`` over the batch's roots and keeps
only the distances; at n = 65536 and L = 512 that materializes a
[32, n+1, L] table of int32 and one of int64.  Here only the distances
are computed, in chunks of roots (``query.one_to_all_dist_batch``);
the result is identical.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.bfs import (MultiRelaxFn, RelaxFn,
                                  multi_pruned_spc_bfs, pruned_spc_bfs)
from repro_torch.core.graph import Graph, degrees
from repro_torch.core.labels import (SPCIndex, bulk_append,
                                     bulk_append_batch, empty_index, repad)
from repro_torch.core.order import graph_ordering, relabel_graph
from repro_torch.core.query import one_to_all_dist, one_to_all_dist_batch


def _hub_round(g: Graph, idx: SPCIndex, v: int,
               relax_fn: RelaxFn | None = None) -> SPCIndex:
    dbar = one_to_all_dist(idx, v, limit=v)  # PreQuery(v, .) for all v
    res = pruned_spc_bfs(g, v, 0, 1, dbar, rank_floor=v, relax_fn=relax_fn)
    return bulk_append(idx, v, res.dist, res.cnt, res.keep)


def build_index(g: Graph, l_cap: int,
                relax_fn: RelaxFn | None = None) -> SPCIndex:
    """Construct the SPC-Index of ``g`` with label capacity ``l_cap``.

    The returned index's ``overflow`` is > 0 if any label did not fit;
    callers then retry with a larger ``l_cap``.
    """
    idx = empty_index(g.n, l_cap, device=g.device)
    for v in range(g.n):
        idx = _hub_round(g, idx, v, relax_fn)
    return idx


def provision_l_cap(g: Graph, floor: int = 4) -> int:
    """A starting label capacity from the graph's degree statistics
    (mean + 2 sqrt(mean) + 1, rounded up to a power of two, capped at
    n + 1)."""
    n = g.n
    if n == 0:
        return floor
    deg = degrees(g).cpu().numpy()[:n].astype(np.float64)
    mean = float(deg.mean())
    est = int(np.ceil(mean + 2.0 * np.sqrt(mean) + 1.0))
    cap = floor
    while cap < max(est, floor):
        cap *= 2
    return min(cap, n + 1)


def _hub_batch_round(g: Graph, idx: SPCIndex, h0: int, hub_batch: int,
                     multi_relax_fn: MultiRelaxFn | None = None
                     ) -> SPCIndex:
    """One batch of ``hub_batch`` consecutive hubs [h0, h0 + B).

    Committed pruning distances are PreQuery of each root against the
    index as of h0; in-batch pruning happens inside the lockstep BFS.
    Tail lanes with ``h0 + b >= n`` are inactive and append nothing.
    """
    roots = h0 + torch.arange(hub_batch, dtype=torch.int32, device=g.device)
    roots_c = torch.clamp(roots, max=g.n)  # inactive -> dump row
    dbar = one_to_all_dist_batch(idx, roots_c, limit=h0)
    res = multi_pruned_spc_bfs(g, roots, dbar, multi_relax_fn=multi_relax_fn)
    return bulk_append_batch(idx, h0, res.dist, res.cnt, res.keep)


def build_index_batched(
    g: Graph,
    l_cap: int | None = None,
    *,
    hub_batch: int = 32,
    order: str = "id",
    multi_relax_fn: MultiRelaxFn | None = None,
    on_regrow: Callable[[int], None] | None = None,
) -> SPCIndex:
    """Batched SPC-Index construction; order-identical to
    :func:`build_index` on the same (relabeled) graph.

    Host-driven loop over ``ceil(n / hub_batch)`` rounds, one overflow
    read (host sync) per round.  Non-identity ``order`` relabels the
    graph into rank space first; the caller translates ids through
    ``repro_torch.core.order.graph_ordering(g, order)``.  ``on_regrow``
    is called with the new capacity on every overflow retry.
    """
    if hub_batch < 1:
        raise ValueError(f"hub_batch must be >= 1, got {hub_batch}")
    ordering = graph_ordering(g, order)
    g = relabel_graph(g, ordering)
    if l_cap is None:
        l_cap = provision_l_cap(g)
    idx = empty_index(g.n, l_cap, device=g.device)
    for h0 in range(0, g.n, hub_batch):
        snap = idx
        while True:
            idx = _hub_batch_round(g, snap, h0, hub_batch, multi_relax_fn)
            if int(idx.overflow) == 0:
                break
            snap = repad(snap, snap.l_cap * 2)
            if on_regrow is not None:
                on_regrow(snap.l_cap)
    return idx
