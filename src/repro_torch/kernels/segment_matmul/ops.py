"""Scatter-add and GNN aggregation entry points (port of
``repro.kernels.segment_matmul.ops``).

``scatter_add``: segment sums of per-edge values.
``gather_scatter``: message = gather(node_feats, src); out =
scatter_add(message, dst).

The device decides the route: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain version.  There is no fallback from
one to the other, and the reference's ``use_kernel`` / ``interpret`` /
``block_e`` / ``block_n`` flags have no counterpart: the kernel has no
interpret mode, and its chunking does not depend on the caller.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_matmul.kernel import segment_matmul_cuda
from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref


def scatter_add(vals: torch.Tensor, dst: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[i] = sum of vals[e] over e with dst[e] == i; ids outside
    [0, num_segments) are dropped."""
    if vals.device.type == "cuda":
        if dst.dtype != torch.int32:
            # the kernel takes int32 ids; clamping first keeps every
            # dropped id dropped
            dst = dst.clamp(-1, num_segments).to(torch.int32)
        return segment_matmul_cuda(vals.contiguous(), dst.contiguous(),
                                   num_segments)
    if vals.device.type != "cpu":
        raise ValueError(f"scatter_add: unsupported device {vals.device}")
    return segment_matmul_ref(vals, dst, num_segments)


def gather_scatter(node_feats: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of node_feats[src[e]] over the edges e into dst[e]."""
    return scatter_add(torch.index_select(node_feats, 0, src), dst,
                       num_segments)
