"""IncSPC: incremental SPC-Index maintenance for edge insertion
(Algorithms 2 and 3).

Port of ``repro.core.incremental``.  The reference loops over the 2 x
L_cap sorted union slots of L(a) and L(b) inside a ``fori_loop`` with a
``lax.cond`` per slot.  Here the loop runs on the host: the slot
conditions read ``aff``, ``first``, ``in_a`` and ``in_b`` of the
*pre-event* index (AFF is defined on L_i), so the two label rows are
copied to the host once per event and slots that fail the test cost no
device work at all.

Per affected hub: one dense SpcQuery(h, .) distance table, one pruned
BFS and one upsert, as in the reference; the upsert and its read of the
existing (h, .) entries run on the rows the BFS keeps
(``labels.upsert_rows``), where the reference rewrites every row.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.bfs import RelaxFn, pruned_spc_bfs
from repro_torch.core.graph import Graph
from repro_torch.core.labels import SPCIndex, _first_true, upsert_rows
from repro_torch.core.query import one_to_all_dist


def _inc_update(g: Graph, idx: SPCIndex, h: int, va: int, vb: int,
                relax_fn: RelaxFn | None = None) -> SPCIndex:
    """Algorithm 3, bulk form, on the rows the BFS keeps."""
    # seed from the (h, d, c) entry of L(va), read without a host sync
    pos = _first_true(idx.hub[va] == h)
    d0 = idx.dist[va, pos] + 1
    c0 = idx.cnt[va, pos]
    d_full = one_to_all_dist(idx, h)  # SpcQuery(h, v) for every v
    res = pruned_spc_bfs(g, vb, d0, c0, dbar=d_full, rank_floor=h,
                         relax_fn=relax_fn)
    rows = res.keep.nonzero()[:, 0]
    # existing (h, ., .) entries of those rows (pre-update values)
    eq = idx.hub[rows] == h
    at = _first_true(eq, 1)[:, None]
    d_i = idx.dist[rows].gather(1, at)[:, 0]
    c_i = idx.cnt[rows].gather(1, at)[:, 0]
    d_r = res.dist[rows]
    # "if d = d_i then c <- c + c_i": accumulate equal-length counts
    c_r = res.cnt[rows] + torch.where(eq.any(dim=1) & (d_r == d_i), c_i, 0)
    return upsert_rows(idx, rows, h, d_r, c_r)


def inc_spc(g: Graph, idx: SPCIndex, a: int, b: int,
            relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Algorithm 2: insert edge (a, b) and repair the index.  The caller
    guarantees the edge is absent and edge capacity is available."""
    n = idx.n
    rows = idx.hub[[a, b]].cpu().numpy()  # the one host copy per event
    hubs_a, hubs_b = rows[0], rows[1]
    in_a = np.zeros(n + 1, dtype=bool)
    in_b = np.zeros(n + 1, dtype=bool)
    in_a[hubs_a[hubs_a < n]] = True
    in_b[hubs_b[hubs_b < n]] = True
    aff = np.sort(np.concatenate([hubs_a, hubs_b]))
    first = np.concatenate([[True], aff[1:] != aff[:-1]])

    g2 = G.insert_edge(g, a, b)
    for k in range(aff.shape[0]):
        h = int(aff[k])
        if not (first[k] and h < n):
            continue
        if in_a[h] and h <= b:
            idx = _inc_update(g2, idx, h, a, b, relax_fn)
        if in_b[h] and h <= a:
            idx = _inc_update(g2, idx, h, b, a, relax_fn)
    return g2, idx


def inc_spc_batch(g: Graph, idx: SPCIndex, edges,
                  relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Apply ``edges`` [B, 2] in order; rows with a == b are padding.
    Caller guarantees capacity for 2B directed slots and absence of the
    inserted edges."""
    for a, b in np.asarray(edges, dtype=np.int64).reshape(-1, 2).tolist():
        if a != b:
            g, idx = inc_spc(g, idx, a, b, relax_fn)
    return g, idx
