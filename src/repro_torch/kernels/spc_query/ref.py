"""Plain PyTorch version of the spc_query kernel (int64 counts).

The L x L comparison table of the reference's ``spc_query_ref`` with
int64 counts instead of fp32, evaluated in chunks of pairs so the
[chunk, L, L] temporaries stay bounded.  The wrapper uses it for CPU
tensors; on the card it is what the kernel is held against.
"""

from __future__ import annotations

import torch

INF = 1 << 28
_BIG = INF * 2

#: Upper bound on the elements of one chunk's [chunk, L, L] table.
_TABLE_ELEMS = 1 << 26


def spc_query_ref(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """(dist int32[B], count int64[B]); disconnected pairs -> (INF, 0)."""
    b, l_cap = hub_s.shape
    chunk = max(1, _TABLE_ELEMS // max(l_cap * l_cap, 1))
    ds, cs = [], []
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        eq = hub_s[sl, :, None] == hub_t[sl, None, :]
        dsum = torch.where(eq, dist_s[sl, :, None] + dist_t[sl, None, :],
                           _BIG)
        d = dsum.amin(dim=(1, 2))
        prod = cnt_s[sl, :, None] * cnt_t[sl, None, :]
        c = torch.where(dsum == d[:, None, None], prod, 0).sum(
            dim=(1, 2), dtype=torch.int64)
        connected = d < INF
        ds.append(torch.where(connected, d, INF).to(torch.int32))
        cs.append(torch.where(connected, c, 0))
    if not ds:
        return (torch.empty(0, dtype=torch.int32, device=hub_s.device),
                torch.empty(0, dtype=torch.int64, device=hub_s.device))
    return torch.cat(ds), torch.cat(cs)
