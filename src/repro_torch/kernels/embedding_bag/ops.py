"""EmbeddingBag / embedding lookup (port of
``repro.kernels.embedding_bag.ops``).

``embedding_bag``: multi-hot pooling (sum or mean) with id padding.
``embedding_lookup``: plain row gather [B, S, D].

The device decides the route: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain version.  There is no fallback from
one to the other, and the reference's ``use_kernel`` / ``interpret``
flags have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def _with_zero_row(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, torch.zeros_like(table[:1])], dim=0)


def _bag_sum(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if ids.device.type == "cuda":
        # the kernel takes int32 ids, as the reference's kernel route does
        return embedding_bag_cuda(ids.to(torch.int32).contiguous(),
                                  table.contiguous())
    if ids.device.type != "cpu":
        raise ValueError(f"embedding_bag: unsupported device {ids.device}")
    return embedding_bag_ref(ids, table)


def embedding_bag(ids: torch.Tensor, table: torch.Tensor, *,
                  mode: str = "sum", pad_id: int | None = None
                  ) -> torch.Tensor:
    """out[b] = pool over s of table[ids[b, s]] (pad ids contribute 0;
    ``mode="mean"`` divides by the number of valid ids, at least 1)."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    v = table.shape[0]
    if pad_id is not None:
        ids = torch.where(ids == pad_id, v, ids)
    out = _bag_sum(ids, _with_zero_row(table))
    if mode == "mean":
        valid = (ids < v).to(table.dtype).sum(dim=1, keepdim=True)
        out = out / valid.clamp(min=1)
    return out


def embedding_lookup(ids: torch.Tensor, table: torch.Tensor, *,
                     pad_id: int | None = None) -> torch.Tensor:
    """Row gather [B, S] -> [B, S, D]; pad ids map to zeros."""
    v = table.shape[0]
    if pad_id is not None:
        ids = torch.where(ids == pad_id, v, ids)
    return _with_zero_row(table)[ids.clamp(max=v).long()]
