"""Query an SPCIndex through the spc_query kernel.

``spc_query`` dispatches on where the rows lie: CUDA tensors launch the
kernel (or raise), CPU tensors take the plain version.  There is no
fallback from one to the other.

The TPU wrapper partitions each batch by a per-row count bound because
its fp32 kernel is exact only to 2^24.  This kernel counts in int64 and
is exact for every row, so :func:`exact_query_batch` needs no
partition.  On the card it is one launch that reads the label rows by
vertex id, with no gather; on the CPU the plain version gathers the rows
and intersects them.  Ids outside [0, n] follow the reference's gather
rule on both (:func:`wrap_ids`).
"""

from __future__ import annotations

import torch

from repro_torch.core.labels import SPCIndex
from repro_torch.core.query import gather_rows
from repro_torch.kernels.spc_query.kernel import (spc_query_cuda,
                                                  spc_query_index_cuda)
from repro_torch.kernels.spc_query.ref import spc_query_ref


def spc_query(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """(dist int32[B], count int64[B]) over gathered [B, L] rows: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if hub_s.device.type == "cuda":
        return spc_query_cuda(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    if hub_s.device.type != "cpu":
        raise ValueError(f"spc_query: unsupported device {hub_s.device}")
    return spc_query_ref(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)


def _ids(idx: SPCIndex, v) -> torch.Tensor:
    return torch.as_tensor(v, device=idx.device).long().reshape(-1)


def wrap_ids(idx: SPCIndex, v) -> torch.Tensor:
    """The rows of ids ``v`` under the reference's gather rule (``jnp``
    indexing): a negative id wraps once (id + n + 1), then the row is
    clamped to [0, n]."""
    v = _ids(idx, v)
    return torch.where(v < 0, v + (idx.n + 1), v).clamp(0, idx.n)


def prep_rows(idx: SPCIndex, s, t):
    """The six gathered operands for a pair batch: the s side keeps its
    pad hub n, the t side is re-padded to n + 1 so pads never match."""
    hub_s, dist_s, cnt_s = gather_rows(idx, wrap_ids(idx, s))
    hub_t, dist_t, cnt_t = gather_rows(idx, wrap_ids(idx, t))
    hub_t = torch.where(hub_t == idx.n, idx.n + 1, hub_t)
    return hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t


def exact_query_batch(idx: SPCIndex, s, t):
    """(dist int32[B], count int64[B]) for B (s, t) pairs; exact for every
    row.  On the card: one launch of the kernel on the index and the ids;
    on the CPU: the plain version on the gathered rows."""
    if idx.device.type == "cuda":
        return spc_query_index_cuda(idx.hub, idx.dist, idx.cnt,
                                    _ids(idx, s).contiguous(),
                                    _ids(idx, t).contiguous())
    if idx.device.type != "cpu":
        raise ValueError(f"exact_query_batch: unsupported device "
                         f"{idx.device}")
    return spc_query_ref(*prep_rows(idx, s, t))
