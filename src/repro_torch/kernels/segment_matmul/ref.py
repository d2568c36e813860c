"""Plain PyTorch version of the segment_matmul kernel.

``out[i] = sum of vals[e] over e with dst[e] == i`` for i in [0, N):
ids outside [0, N), negatives included, are dropped, as the reference's
``segment_matmul_ref`` (``jax.ops.segment_sum``) and its Pallas kernel
drop them.  The sum runs in float32 and is cast once to the dtype of
vals, as the kernel accumulates.  The wrapper uses it for CPU tensors; on
the card it is what the kernel is held against.
"""

from __future__ import annotations

import torch


def segment_matmul_ref(vals: torch.Tensor, dst: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """vals [E, D], dst int [E] -> [num_segments, D] in the dtype of vals."""
    keep = (dst >= 0) & (dst < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, dst[keep].long(), vals[keep].float())
    return out.to(vals.dtype)
