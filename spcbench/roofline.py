"""The yardstick of the query kernel (K1, ``spc_query``): the bytes a
batch of pairs needs, and the card's peak.

The count follows the rule of counting each input byte read once and
each output byte written once, whatever the kernel reads again:

* inputs: the used entries of every distinct label row the batch
  touches (a row asked for by many pairs, or as both a source and a
  target, counts once; pad entries past the row's size do not count),
  16 bytes an entry (hub int32, dist int32, count int64), and the pair
  ids as the engine hands them to the card (int64);
* outputs: a distance (int32) and a count (int64) per pair.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W power limit.
H100_HBM_BYTES_PER_S = 3.35e12
#: hub int32 + dist int32 + count int64.
ENTRY_BYTES = 16
ID_BYTES = 8
ANSWER_BYTES = 4 + 8


def k1_bytes(row_sizes: np.ndarray, s: np.ndarray, t: np.ndarray) -> int:
    """Bytes the pairs (s[i], t[i]) need, given each row's used entries."""
    s = np.asarray(s, dtype=np.int64).reshape(-1)
    t = np.asarray(t, dtype=np.int64).reshape(-1)
    rows = np.unique(np.concatenate([s, t]))
    entries = int(np.asarray(row_sizes, dtype=np.int64)[rows].sum())
    return (ENTRY_BYTES * entries + ID_BYTES * (s.size + t.size)
            + ANSWER_BYTES * s.size)


def least_seconds(nbytes: int) -> float:
    """The least time the card's HBM needs to move ``nbytes``."""
    return nbytes / H100_HBM_BYTES_PER_S
