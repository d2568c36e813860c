"""SPC-Index as fixed-capacity label matrices (torch tensors).

Port of ``repro.core.labels``.  Each vertex row holds up to ``l_cap``
labels ``(hub, dist, cnt)`` sorted by hub id ascending.  Padding:
``hub = n`` (sorts after every real hub), ``dist = INF``, ``cnt = 0``.

The four bulk mutation helpers apply one hub's (or one hub batch's)
labels to every row at once under boolean masks, and are the only label
writers, so they keep the ``cnt_sum`` invariant
(``cnt_sum[v] == sum(cnt[v])``).  Lost writes (a row already full) are
counted in ``overflow``, a 0-d int32 tensor on the index's device; the
drivers read it once per round or event chunk and regrow.

All helpers are functional (they return a new ``SPCIndex`` and leave
their input untouched) because the drivers keep pre-round / pre-chunk
snapshots for the overflow retry.  ``bulk_upsert`` and ``bulk_remove``
compute on the masked rows alone and copy them into new matrices; the
row ids cost one host sync (``nonzero``) per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import INF, resolve_device


@dataclasses.dataclass(frozen=True)
class SPCIndex:
    hub: torch.Tensor      # int32[n + 1, L_cap], pad = n
    dist: torch.Tensor     # int32[n + 1, L_cap], pad = INF
    cnt: torch.Tensor      # int64[n + 1, L_cap], pad = 0
    size: torch.Tensor     # int32[n + 1]
    cnt_sum: torch.Tensor  # int64[n + 1]: sum of the row's counts
    overflow: torch.Tensor  # int32 0-d: #lost label writes (grow & retry)
    n: int

    @property
    def l_cap(self) -> int:
        return int(self.hub.shape[1])

    @property
    def device(self) -> torch.device:
        return self.hub.device

    def total_entries(self) -> int:
        return int(self.size.sum())


def recompute_cnt_sum(cnt: torch.Tensor) -> torch.Tensor:
    """The cached ``cnt_sum`` field from scratch."""
    return cnt.sum(dim=1, dtype=torch.int64)


def empty_index(n: int, l_cap: int, *, device="cuda") -> SPCIndex:
    dev = resolve_device(device)
    return SPCIndex(
        hub=torch.full((n + 1, l_cap), n, dtype=torch.int32, device=dev),
        dist=torch.full((n + 1, l_cap), INF, dtype=torch.int32, device=dev),
        cnt=torch.zeros((n + 1, l_cap), dtype=torch.int64, device=dev),
        size=torch.zeros(n + 1, dtype=torch.int32, device=dev),
        cnt_sum=torch.zeros(n + 1, dtype=torch.int64, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        n=n,
    )


def index_from_numpy(n: int, hub, dist, cnt, size, cnt_sum=None, *,
                     device="cuda") -> SPCIndex:
    """An SPCIndex from host arrays (e.g. a reference ``state_dict``);
    ``cnt_sum`` is recomputed when absent (legacy state dicts)."""
    dev = resolve_device(device)

    def put(x, dtype):  # a copy: never aliases (read-only) caller arrays
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    cnt_t = put(cnt, torch.int64)
    return SPCIndex(
        hub=put(hub, torch.int32), dist=put(dist, torch.int32), cnt=cnt_t,
        size=put(size, torch.int32),
        cnt_sum=(put(cnt_sum, torch.int64) if cnt_sum is not None
                 else recompute_cnt_sum(cnt_t)),
        overflow=torch.zeros((), dtype=torch.int32, device=dev), n=n)


def _pad_cols(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    fill = torch.full((x.shape[0], pad), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=1)


def repad(idx: SPCIndex, new_cap: int) -> SPCIndex:
    """Grow label capacity (clears the overflow counter)."""
    if new_cap < idx.l_cap:
        raise ValueError("cannot shrink label capacity")
    pad = new_cap - idx.l_cap
    return SPCIndex(
        hub=_pad_cols(idx.hub, pad, idx.n),
        dist=_pad_cols(idx.dist, pad, INF),
        cnt=_pad_cols(idx.cnt, pad, 0),
        size=idx.size,
        cnt_sum=idx.cnt_sum,  # pad entries carry cnt = 0
        overflow=torch.zeros((), dtype=torch.int32, device=idx.device),
        n=idx.n,
    )


def add_vertices(idx: SPCIndex, count: int) -> SPCIndex:
    """Append ``count`` fresh vertices (each gets a self label); the dump
    row moves to the end and the pad sentinel becomes ``n + count``."""
    n, n_new, dev = idx.n, idx.n + count, idx.device
    hub = torch.full((n_new + 1, idx.l_cap), n_new, dtype=torch.int32,
                     device=dev)
    dist = torch.full((n_new + 1, idx.l_cap), INF, dtype=torch.int32,
                      device=dev)
    cnt = torch.zeros((n_new + 1, idx.l_cap), dtype=torch.int64, device=dev)
    size = torch.zeros(n_new + 1, dtype=torch.int32, device=dev)
    cnt_sum = torch.zeros(n_new + 1, dtype=torch.int64, device=dev)
    hub[:n] = torch.where(idx.hub[:n] == n, n_new, idx.hub[:n])
    dist[:n] = idx.dist[:n]
    cnt[:n] = idx.cnt[:n]
    size[:n] = idx.size[:n]
    cnt_sum[:n] = idx.cnt_sum[:n]
    fresh = torch.arange(n, n_new, device=dev)
    hub[fresh, 0] = fresh.to(torch.int32)
    dist[fresh, 0] = 0
    cnt[fresh, 0] = 1
    size[fresh] = 1
    cnt_sum[fresh] = 1
    return SPCIndex(hub=hub, dist=dist, cnt=cnt, size=size, cnt_sum=cnt_sum,
                    overflow=idx.overflow, n=n_new)


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none), the
    ``jnp.argmax``-on-bool idiom of the reference."""
    return mask.to(torch.uint8).argmax(dim=dim)


# --------------------------------------------------------------------------
# Bulk label mutations for one hub h (vectorized over all rows).
# --------------------------------------------------------------------------
def bulk_append(idx: SPCIndex, h, d_new, c_new, mask) -> SPCIndex:
    """Append label (h, d_new[v], c_new[v]) to every row v with mask[v].

    Only valid during construction where hubs arrive in ascending id
    order (append keeps rows sorted).
    """
    col = torch.clamp(idx.size, max=idx.l_cap - 1).long()[:, None]
    fits = mask & (idx.size < idx.l_cap)
    lost = mask & ~fits
    f = fits[:, None]
    hub = idx.hub.scatter(1, col, torch.where(
        f, torch.as_tensor(h, dtype=torch.int32, device=idx.device),
        idx.hub.gather(1, col)))
    dist = idx.dist.scatter(1, col, torch.where(
        f, d_new.to(torch.int32)[:, None], idx.dist.gather(1, col)))
    cnt = idx.cnt.scatter(1, col, torch.where(
        f, c_new.to(torch.int64)[:, None], idx.cnt.gather(1, col)))
    size = idx.size + fits.to(torch.int32)
    cnt_sum = idx.cnt_sum + torch.where(fits, c_new.to(torch.int64), 0)
    return dataclasses.replace(
        idx, hub=hub, dist=dist, cnt=cnt, size=size, cnt_sum=cnt_sum,
        overflow=idx.overflow + lost.sum(dtype=torch.int32))


def bulk_append_batch(idx: SPCIndex, h0: int, d_new, c_new,
                      mask) -> SPCIndex:
    """Append one whole hub batch's labels in a single masked scatter.

    ``d_new`` / ``c_new`` / ``mask`` are [B, n + 1]; lane ``b`` holds the
    BFS result of hub ``h0 + b``.  The kept labels of row v land at
    columns ``size[v] + rank-within-row`` in ascending lane order; lanes
    past the row's capacity are counted lost.

    The reference scatters the lost lanes out of bounds with
    ``mode="drop"``.  torch has no drop mode, so the scatter goes into
    a copy widened by B columns and each lost lane of a row lands in its
    own spare column ``l_cap + b`` (no duplicate indices), which is then
    cut away.
    """
    b = mask.shape[0]
    l_cap = idx.l_cap
    rank = torch.cumsum(mask.to(torch.int32), dim=0) - 1        # [B, n+1]
    col = idx.size[None, :] + torch.where(mask, rank, 0)
    fits = mask & (col < l_cap)
    lost = mask & ~fits
    lane = torch.arange(b, device=idx.device, dtype=torch.int32)[:, None]
    cols = torch.where(fits, col, l_cap + lane).long().t()       # [n+1, B]
    hubs = (h0 + lane).to(torch.int32).expand(b, idx.n + 1).t()
    c64 = c_new.to(torch.int64)

    def put(x, vals, pad):
        wide = _pad_cols(x, b, pad).scatter(1, cols, vals)
        return wide[:, :l_cap].contiguous()

    hub = put(idx.hub, hubs, idx.n)
    dist = put(idx.dist, d_new.to(torch.int32).t(), INF)
    cnt = put(idx.cnt, c64.t(), 0)
    size = idx.size + fits.sum(dim=0, dtype=torch.int32)
    cnt_sum = idx.cnt_sum + torch.where(fits, c64, 0).sum(dim=0)
    return dataclasses.replace(
        idx, hub=hub, dist=dist, cnt=cnt, size=size, cnt_sum=cnt_sum,
        overflow=idx.overflow + lost.sum(dtype=torch.int32))


def _masked_rows(mask: torch.Tensor) -> torch.Tensor:
    """Ascending ids of the rows with ``mask`` set (one host sync)."""
    return mask.nonzero()[:, 0]


def _rows_of(idx: SPCIndex, rows: torch.Tensor):
    return (idx.hub[rows], idx.dist[rows], idx.cnt[rows], idx.size[rows],
            idx.cnt_sum[rows])


def _with_rows(idx: SPCIndex, rows: torch.Tensor, hub, dist, cnt, size,
               cnt_sum, overflow) -> SPCIndex:
    """A new index with ``rows`` (distinct) replaced."""
    return dataclasses.replace(
        idx, hub=idx.hub.index_copy(0, rows, hub),
        dist=idx.dist.index_copy(0, rows, dist),
        cnt=idx.cnt.index_copy(0, rows, cnt),
        size=idx.size.index_copy(0, rows, size),
        cnt_sum=idx.cnt_sum.index_copy(0, rows, cnt_sum), overflow=overflow)


def upsert_rows(idx: SPCIndex, rows: torch.Tensor, h: int, d_rows,
                c_rows) -> SPCIndex:
    """Replace-or-sorted-insert label (h, d_rows[k], c_rows[k]) in row
    ``rows[k]`` (distinct ids): :func:`bulk_upsert` over those rows.

    Rows that already contain hub h are overwritten in place; otherwise
    the row is shifted right at the insertion point.
    """
    if rows.numel() == 0:
        return idx
    hub, dist, cnt, size, cnt_sum = _rows_of(idx, rows)
    eq = hub == h                                      # [k, L]
    has = eq.any(dim=1)
    old_c = cnt.gather(1, _first_true(eq, 1)[:, None])[:, 0]
    d32 = d_rows.to(torch.int32)[:, None]
    c64 = c_rows.to(torch.int64)
    # --- replace path -----------------------------------------------------
    rep = has[:, None] & eq
    dist = torch.where(rep, d32, dist)
    cnt = torch.where(rep, c64[:, None], cnt)
    # --- insert path (shift right at pos) ----------------------------------
    fits = ~has & (size < idx.l_cap)
    lost = ~has & ~fits
    pos = (hub < h).sum(dim=1, dtype=torch.int32)[:, None]
    cols = torch.arange(idx.l_cap, device=idx.device)[None, :]
    fitsb = fits[:, None]
    shift = torch.clamp(cols - 1, min=0).expand_as(hub)

    def shifted(x, new):
        sh = x.gather(1, shift)
        return torch.where(
            fitsb, torch.where(cols < pos, x,
                               torch.where(cols == pos, new, sh)), x)

    new_hub = shifted(hub, torch.as_tensor(h, dtype=torch.int32,
                                           device=idx.device))
    return _with_rows(
        idx, rows, new_hub, shifted(dist, d32), shifted(cnt, c64[:, None]),
        size + fits.to(torch.int32),
        cnt_sum + torch.where(has, c64 - old_c, 0)   # replaced
        + torch.where(fits, c64, 0),                 # inserted
        idx.overflow + lost.sum(dtype=torch.int32))


def bulk_upsert(idx: SPCIndex, h, d_new, c_new, mask) -> SPCIndex:
    """Replace-or-sorted-insert label (h, d_new[v], c_new[v]) where mask[v].

    Only the masked rows change, so the work runs on those rows alone
    (:func:`upsert_rows`): the reference rewrites the whole [n + 1, L]
    matrices, which on the card costs a pass over the index per hub.
    """
    rows = _masked_rows(mask)
    return upsert_rows(idx, rows, h, d_new[rows], c_new[rows])


def bulk_remove(idx: SPCIndex, h, mask) -> SPCIndex:
    """Remove label with hub h (shift left) from every row v with mask[v]
    (computed on the masked rows alone, as :func:`bulk_upsert`)."""
    rows = _masked_rows(mask)
    if rows.numel() == 0:
        return idx
    hub, dist, cnt, size, cnt_sum = _rows_of(idx, rows)
    eq = hub == h
    act = eq.any(dim=1)
    pos = _first_true(eq, 1)[:, None]
    cols = torch.arange(idx.l_cap, device=idx.device)[None, :]
    nxt = torch.clamp(cols + 1, max=idx.l_cap - 1).expand_as(hub)
    last = cols == idx.l_cap - 1
    sel = act[:, None] & (cols >= pos)

    def shifted(x, pad):
        return torch.where(sel, torch.where(last, pad, x.gather(1, nxt)), x)

    return _with_rows(
        idx, rows, shifted(hub, idx.n), shifted(dist, INF), shifted(cnt, 0),
        size - act.to(torch.int32),
        cnt_sum - torch.where(act, cnt.gather(1, pos)[:, 0], 0),
        idx.overflow)


def reset_isolated_row(idx: SPCIndex, v: int) -> SPCIndex:
    """Collapse row ``v`` to its self label (Section 3.2.3)."""
    hub, dist = idx.hub.clone(), idx.dist.clone()
    cnt, size, cnt_sum = idx.cnt.clone(), idx.size.clone(), idx.cnt_sum.clone()
    hub[v] = idx.n
    hub[v, 0] = v
    dist[v] = INF
    dist[v, 0] = 0
    cnt[v] = 0
    cnt[v, 0] = 1
    size[v] = 1
    cnt_sum[v] = 1
    return dataclasses.replace(idx, hub=hub, dist=dist, cnt=cnt, size=size,
                               cnt_sum=cnt_sum)


def get_label(idx: SPCIndex, v, h):
    """(found, dist, cnt) of label (h, ., .) in row v (0-d tensors)."""
    eq = idx.hub[v] == h
    pos = _first_true(eq)
    return eq.any(), idx.dist[v, pos], idx.cnt[v, pos]


def index_to_numpy(idx: SPCIndex) -> dict:
    """The label arrays as host numpy (reference dtypes)."""
    return {"hub": idx.hub.cpu().numpy(), "dist": idx.dist.cpu().numpy(),
            "cnt": idx.cnt.cpu().numpy(), "size": idx.size.cpu().numpy(),
            "cnt_sum": idx.cnt_sum.cpu().numpy()}
