"""DecSPC: decremental SPC-Index maintenance for edge deletion
(Algorithms 4, 5 and 6).

Port of ``repro.core.decremental``.  Phase 1 (SRRSearch) runs two
conditional BFSs from the deletion endpoints before the edge is
removed; the affected sets SR/R are boolean vertex masks.  Phase 2
walks the affected hubs in rank order: per hub one PreQuery table, one
pruned BFS, one bulk upsert and, for common hubs of a and b, one bulk
removal.

The reference's ``while_loop`` over ``sr_ids`` becomes a host loop:
``sr_ids`` (and the per-hub side and common-hub flags) are fixed
before the loop, so they are copied to the host once per event.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.bfs import (RelaxFn, conditional_spc_bfs,
                                  pruned_spc_bfs)
from repro_torch.core.graph import INF, Graph
from repro_torch.core.labels import (SPCIndex, bulk_remove, bulk_upsert,
                                     reset_isolated_row)
from repro_torch.core.query import one_to_all, one_to_all_dist


class SRRSets(NamedTuple):
    sr_a: torch.Tensor  # bool[n + 1]
    sr_b: torch.Tensor
    r_a: torch.Tensor
    r_b: torch.Tensor
    l_ab: torch.Tensor  # bool[n + 1]: common hubs of a and b


def _side(g: Graph, root: int, d_other, c_other, l_ab,
          relax_fn: RelaxFn | None = None):
    """One direction of Algorithm 5 (run with the edge still present)."""
    res = conditional_spc_bfs(
        g, root, lambda dist, cnt, newly: dist + 1 == d_other,
        relax_fn=relax_fn)
    unpruned = (res.dist < INF) & (res.dist + 1 == d_other)
    sr = unpruned & (l_ab | (res.cnt == c_other))
    return sr, unpruned & ~sr


def _hub_mask(idx: SPCIndex, v: int) -> torch.Tensor:
    """bool[n + 1]: the hubs of L(v) (never the dump slot)."""
    hubs = idx.hub[v].long()
    out = torch.zeros(idx.n + 1, dtype=torch.bool, device=idx.device)
    out[hubs] = hubs < idx.n
    out[idx.n] = False
    return out


def srr_search(g: Graph, idx: SPCIndex, a: int, b: int,
               relax_fn: RelaxFn | None = None) -> SRRSets:
    """Algorithm 5 for both sides."""
    l_ab = _hub_mask(idx, a) & _hub_mask(idx, b)
    d_b, c_b = one_to_all(idx, b)  # SpcQuery(v, b) for every v
    d_a, c_a = one_to_all(idx, a)
    sr_a, r_a = _side(g, a, d_b, c_b, l_ab, relax_fn)
    sr_b, r_b = _side(g, b, d_a, c_a, l_ab, relax_fn)
    return SRRSets(sr_a=sr_a, sr_b=sr_b, r_a=r_a, r_b=r_b, l_ab=l_ab)


def _dec_update(g: Graph, idx: SPCIndex, h: int, affected, h_ab: bool,
                relax_fn: RelaxFn | None = None) -> SPCIndex:
    """Algorithm 6, bulk form (post-deletion graph)."""
    dpre = one_to_all_dist(idx, h, limit=h)  # PreQuery(h, v) for all v
    res = pruned_spc_bfs(g, h, 0, 1, dbar=dpre, rank_floor=h,
                         relax_fn=relax_fn)
    upd = res.keep & affected  # U[.]
    idx = bulk_upsert(idx, h, res.dist, res.cnt, upd)
    if h_ab:
        idx = bulk_remove(idx, h, affected & ~upd)
    return idx


def dec_spc(g: Graph, idx: SPCIndex, a: int, b: int,
            relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Algorithm 4: delete edge (a, b) and repair the index."""
    n = idx.n
    sets = srr_search(g, idx, a, b, relax_fn)
    g2 = G.delete_edge(g, a, b)
    # sr_ids, each hub's side and its common-hub flag are fixed before
    # the hub loop: one host copy for all three
    flags = torch.stack([sets.sr_a | sets.sr_b, sets.sr_a,
                         sets.l_ab])[:, :n].cpu().numpy()
    aff_b = sets.sr_b | sets.r_b
    aff_a = sets.sr_a | sets.r_a
    for h in flags[0].nonzero()[0].tolist():  # ascending id = rank order
        affected = aff_b if flags[1, h] else aff_a
        idx = _dec_update(g2, idx, h, affected, bool(flags[2, h]), relax_fn)
    return g2, idx


def dec_spc_step(g: Graph, idx: SPCIndex, a: int, b: int,
                 relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Single deletion with the Section 3.2.3 isolated-vertex fast path:
    when the lower-ranked endpoint has degree 1 its row collapses to the
    self label.  The degree test costs one host sync."""
    hi = max(a, b)
    deg_hi = int((g.src[:g.m2] == hi).sum())
    if deg_hi == 1:
        return G.delete_edge(g, a, b), reset_isolated_row(idx, hi)
    return dec_spc(g, idx, a, b, relax_fn)


def dec_spc_batch(g: Graph, idx: SPCIndex, edges,
                  relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Delete ``edges`` [B, 2] in order; rows with a == b are padding."""
    for a, b in np.asarray(edges, dtype=np.int64).reshape(-1, 2).tolist():
        if a != b:
            g, idx = dec_spc_step(g, idx, a, b, relax_fn)
    return g, idx
