"""Plain PyTorch version of the embedding_bag kernel.

``out[b] = sum over s of table[ids[b, s]]`` with every id outside
``[0, V)`` mapped onto the last row ``V`` (``table[V]`` is the zero row
the ops wrapper appends; the reference clamps ids above ``V`` onto it).
The sum runs in float32 and is cast to the table's dtype, as the
kernel accumulates.  The wrapper uses it for CPU tensors; on the card
it is what the kernel is held against.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids int [B, S], table [V + 1, D] -> [B, D] in the table's dtype."""
    v = table.shape[0] - 1
    rows = torch.where((ids >= 0) & (ids < v), ids, v).long()
    return table[rows].sum(dim=1, dtype=torch.float32).to(table.dtype)
