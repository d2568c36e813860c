"""SPC-Index query evaluation (Algorithm 1 and the PreQuery variant).

Port of ``repro.core.query``.  Two strategies:

* row-level cores over *gathered* label rows ([B, L] per operand):
  ``merge_rows`` (sorted merge by binary search, the serving default)
  and ``table_rows`` (the L x L comparison table);
* ``one_to_all`` -- the dense-source trick: scatter L(h) into a dense
  [n+1] table, then every row v evaluates its own labels against it in
  O(L).  Used inside construction and the update engines.

int32 arithmetic stays int32 (``INF + INF < 2^31``); counts are int64
and wrap exactly as the reference's int64 does.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import INF
from repro_torch.core.labels import SPCIndex

_BIG = INF * 2  # > any real distance sum; int32-safe

#: Upper bound on the elements of the [R, n+1, L] candidate table that
#: ``one_to_all_dist_batch`` materializes at once (int32: 1 GiB).
_ONE_TO_ALL_ELEMS = 1 << 28


def _finish(d: torch.Tensor, c: torch.Tensor):
    disconnected = d >= INF
    return (torch.where(disconnected, INF, d).to(torch.int32),
            torch.where(disconnected, 0, c))


def table_rows(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t, limit):
    """Batched L x L comparison-table intersection over gathered rows.

    ``limit`` (an int or an int tensor broadcastable to [B]) masks hubs
    >= limit on the s side (PreQuery); pass n + 1 for the full query.
    Returns (dist int32[B], cnt int64[B]).
    """
    limit = torch.as_tensor(limit, device=hub_s.device)
    if limit.dim() == 1:
        limit = limit[:, None, None]
    eq = (hub_s[:, :, None] == hub_t[:, None, :]) & \
        (hub_s[:, :, None] < limit)
    dsum = torch.where(eq, dist_s[:, :, None] + dist_t[:, None, :], _BIG)
    d = dsum.amin(dim=(1, 2))
    prod = cnt_s[:, :, None] * cnt_t[:, None, :]
    c = torch.where(dsum == d[:, None, None], prod, 0).sum(
        dim=(1, 2), dtype=torch.int64)
    return _finish(d, c)


def merge_rows(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """Batched sorted-merge intersection over gathered rows.

    Rows are sorted by hub id with the pad sentinel last, so one binary
    probe of L(t) per label of L(s) (``searchsorted``, left side as in
    the reference) finds every common hub.  Tolerates a t side re-padded
    to n + 1.  Returns (dist int32[B], cnt int64[B]).
    """
    l_cap = hub_t.shape[1]
    pos = torch.searchsorted(hub_t.contiguous(), hub_s.contiguous())
    pos_c = torch.clamp(pos, max=l_cap - 1)
    match = hub_t.gather(1, pos_c) == hub_s
    dsum = torch.where(match, dist_s + dist_t.gather(1, pos_c), _BIG)
    d = dsum.amin(dim=1)
    c = torch.where(dsum == d[:, None], cnt_s * cnt_t.gather(1, pos_c),
                    0).sum(dim=1, dtype=torch.int64)
    return _finish(d, c)


def gather_rows(idx: SPCIndex, v: torch.Tensor):
    """Label rows of vertices ``v``: (hub, dist, cnt), each [B, L_cap]."""
    return idx.hub[v], idx.dist[v], idx.cnt[v]


def _ids(idx: SPCIndex, v) -> torch.Tensor:
    return torch.as_tensor(v, device=idx.device).long().reshape(-1)


def batched_query_merge(idx: SPCIndex, s, t):
    """Algorithm 1 by sorted merge for B pairs (the merge route)."""
    return merge_rows(*gather_rows(idx, _ids(idx, s)),
                      *gather_rows(idx, _ids(idx, t)))


def batched_query(idx: SPCIndex, s, t):
    """Algorithm 1 by the L x L table for B pairs (the table route)."""
    return table_rows(*gather_rows(idx, _ids(idx, s)),
                      *gather_rows(idx, _ids(idx, t)), idx.n + 1)


def pair_query(idx: SPCIndex, s: int, t: int):
    """(dist, count) between s and t; (INF, 0) if disconnected."""
    d, c = batched_query(idx, [s], [t])
    return d[0], c[0]


def pre_pair_query(idx: SPCIndex, s: int, t: int):
    """PreQuery(s, t): only hubs ranked strictly higher than s."""
    rows = gather_rows(idx, _ids(idx, [s])) + gather_rows(idx, _ids(idx, [t]))
    d, c = table_rows(*rows, s)
    return d[0], c[0]


def count_upper_bound_rows(cnt_s, cnt_t):
    """Per-row upper bound ``sum(cnt_s) * sum(cnt_t)`` on the pair count,
    [B] float64 (exact to 2^53)."""
    return (cnt_s.sum(dim=1).to(torch.float64)
            * cnt_t.sum(dim=1).to(torch.float64))


def cached_count_bound(idx: SPCIndex, s, t):
    """:func:`count_upper_bound_rows` from the cached ``cnt_sum`` field."""
    return (idx.cnt_sum[_ids(idx, s)].to(torch.float64)
            * idx.cnt_sum[_ids(idx, t)].to(torch.float64))


# --------------------------------------------------------------------------
# Dense one-vs-all queries.
# --------------------------------------------------------------------------
def _source_hubs(idx: SPCIndex, h: torch.Tensor, limit):
    """Label hubs of the source rows ``h`` [R], entries with hub >= limit
    redirected to the dump slot n (PreQuery restriction)."""
    row_hub = idx.hub[h]                                    # [R, L]
    if limit is not None:
        row_hub = torch.where(row_hub < limit, row_hub, idx.n)
    return row_hub.long()


def _dense(idx: SPCIndex, row_hub, vals, fill):
    """Scatter [R, L] label values into dense [R, n+1] tables.

    Only pad / masked entries share an index (slot n), and that slot
    is reset right after, so the result is deterministic.
    """
    r = row_hub.shape[0]
    out = torch.full((r, idx.n + 1), fill, dtype=vals.dtype,
                     device=idx.device)
    out.scatter_(1, row_hub, vals)
    out[:, idx.n] = fill
    return out


def dense_tables(idx: SPCIndex, h: int, limit=None):
    """Scatter L(h) into dense (dist, cnt) tables of shape [n + 1];
    ``limit`` drops entries of L(h) whose hub id >= limit."""
    hv = _ids(idx, [h])
    row_hub = _source_hubs(idx, hv, limit)
    return (_dense(idx, row_hub, idx.dist[hv], INF)[0],
            _dense(idx, row_hub, idx.cnt[hv], 0)[0])


def _candidates(idx: SPCIndex, dense_d: torch.Tensor, limit):
    """cand[r, v, j] = dense_d[r, hub[v, j]] + dist[v, j], masked to BIG
    where hub[v, j] >= min(limit, n) -- int32 [R, n+1, L]."""
    r = dense_d.shape[0]
    hubs = idx.hub
    cand = torch.index_select(dense_d, 1, hubs.reshape(-1)).view(
        r, idx.n + 1, idx.l_cap) + idx.dist[None]
    keep = hubs < idx.n
    if limit is not None:
        keep &= hubs < limit
    return torch.where(keep[None], cand, _BIG)


def one_to_all(idx: SPCIndex, h: int, limit=None):
    """(dist[n+1], cnt[n+1]) = SpcQuery(h, v) for every v; with
    ``limit=h`` PreQuery(h, v)."""
    dense_d, dense_c = dense_tables(idx, h, limit)
    cand = _candidates(idx, dense_d[None], limit)[0]        # [n+1, L]
    d = cand.amin(dim=1)
    prod = idx.cnt * torch.index_select(
        dense_c, 0, idx.hub.reshape(-1)).view_as(idx.cnt)
    c = torch.where(cand == d[:, None], prod, 0).sum(dim=1,
                                                     dtype=torch.int64)
    return _finish(d, c)


def one_to_all_cols(idx: SPCIndex, roots: torch.Tensor, cols: torch.Tensor):
    """:func:`one_to_all` rows of ``roots`` [R] at the columns ``cols``
    [C] only: (dist int32 [R, C], cnt int64 [R, C]).

    Column v of root h reads only the label rows of h and v, so a row
    whose other columns are known is patched here at O(R * C * L)
    instead of O(R * n * L).  Roots are processed in chunks so that the
    [chunk, C, L] candidate table (int32, with an int64 count table
    beside it) stays under a quarter of ``_ONE_TO_ALL_ELEMS``.
    """
    roots, cols = roots.long(), cols.long()
    hub = idx.hub[cols].long()                              # [C, L]
    keep = hub < idx.n
    flat = hub.reshape(-1)
    chunk = max(1, (_ONE_TO_ALL_ELEMS >> 2) // max(hub.numel(), 1))
    ds, cs = [], []
    for lo in range(0, roots.shape[0], chunk):
        h = roots[lo:lo + chunk]
        row_hub = _source_hubs(idx, h, None)
        dense_d = _dense(idx, row_hub, idx.dist[h], INF)
        dense_c = _dense(idx, row_hub, idx.cnt[h], 0)
        r = h.shape[0]
        cand = torch.where(
            keep[None],
            torch.index_select(dense_d, 1, flat).view(r, *hub.shape)
            + idx.dist[cols][None], _BIG)
        d = cand.amin(dim=2)
        prod = idx.cnt[cols][None] * torch.index_select(
            dense_c, 1, flat).view(r, *hub.shape)
        c = torch.where(cand == d[..., None], prod, 0).sum(
            dim=2, dtype=torch.int64)
        d, c = _finish(d, c)
        ds.append(d)
        cs.append(c)
    return torch.cat(ds), torch.cat(cs)


def one_to_all_dist_batch(idx: SPCIndex, roots: torch.Tensor, limit):
    """The distance half of :func:`one_to_all` for many roots at once:
    int32 [R, n+1], row r = PreQuery(roots[r], .) under ``limit``.

    The batched builder only needs the distances, so the counts are not
    computed; roots are processed in chunks so that the [chunk, n+1, L]
    candidate table stays under ``_ONE_TO_ALL_ELEMS`` elements.
    Identical to the distance output of :func:`one_to_all` per root.
    """
    roots = roots.long()
    per_root = (idx.n + 1) * idx.l_cap
    chunk = max(1, _ONE_TO_ALL_ELEMS // max(per_root, 1))
    out = []
    for lo in range(0, roots.shape[0], chunk):
        rows = _source_hubs(idx, roots[lo:lo + chunk], limit)
        dense_d = _dense(idx, rows, idx.dist[roots[lo:lo + chunk]], INF)
        d = _candidates(idx, dense_d, limit).amin(dim=2)
        out.append(torch.where(d >= INF, INF, d).to(torch.int32))
    return torch.cat(out, dim=0)


def one_to_all_dist(idx: SPCIndex, h: int, limit=None) -> torch.Tensor:
    """The distance half of :func:`one_to_all`, int32 [n + 1] (the
    update engines and the sequential builder use only the distances)."""
    return one_to_all_dist_batch(idx, torch.tensor([h], device=idx.device),
                                 limit)[0]
