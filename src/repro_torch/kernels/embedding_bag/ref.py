"""Plain PyTorch version of the embedding_bag kernel.

``out[b] = sum over s of table[row(ids[b, s])]`` for a table [V + 1, D]
whose last row ``V`` is the zero row the ops wrapper appends: an id in
``[0, V)`` reads its own row, an id in ``[-(V + 1), -1]`` reads row
``V + 1 + id`` (from the end, as the reference's ``jnp.take`` and its
Pallas kernel read it), and every other id reads the zero row (the
reference clamps ids above ``V`` onto it; below ``-(V + 1)`` its plain
version gives NaN and its kernel row 0, which the port does not copy).
The sum runs in float32 and is cast to the table's dtype, as the
kernel accumulates.  The wrapper uses it for CPU tensors; on the card
it is what the kernel is held against.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids int [B, S], table [V + 1, D] -> [B, D] in the table's dtype."""
    v = table.shape[0] - 1
    wrapped = torch.where(ids < 0, ids + (v + 1), ids)
    rows = torch.where((wrapped >= 0) & (wrapped < v), wrapped, v).long()
    return table[rows].sum(dim=1, dtype=torch.float32).to(table.dtype)
