"""The comparison that decides ``correct``, and the controls it must fail.

A pair's answer matches the reference when the pair is reachable and
the distance and the count both equal the reference's, or when it is
unreachable and the answer says so: a count of 0 and a distance of at
least ``n``, which no path in an ``n``-vertex graph has.  The numbers
compared are the pairs that do not match, and the count arrays (answers
and the index's count table) held narrower than the int64 that the
configurations state: every count of these graphs fits int32 and
float32 exactly, so a value can not show a narrowed count, and its
width is compared instead.  Every limit is 0.
"""

from __future__ import annotations

import numpy as np

#: Every number a run compares, with its limit (an exact comparison).
LIMITS = {"mismatched_pairs": 0, "narrow_counts": 0, "missing_answers": 0,
          "versions_behind": 0}

#: The lower precisions the control counts in (int64's nearest below,
#: and the TPU kernel's float32).
CONTROL_DTYPES = (np.int32, np.float32)


def mismatches(n: int, dist, cnt, ref_dist, ref_cnt) -> int:
    """Pairs whose (dist, cnt) differs from the reference's."""
    dist = np.asarray(dist, dtype=np.int64)
    cnt = np.asarray(cnt, dtype=np.int64)
    reach = np.asarray(ref_dist) >= 0
    ok = np.where(reach, (dist == ref_dist) & (cnt == ref_cnt),
                  (dist >= n) & (cnt == 0))
    return int(np.count_nonzero(~ok))


def as_answered(n: int, dist, cnt):
    """The reference's (dist, cnt) in the program's form, an unreachable
    pair's distance ``n``: what a control in the program's place
    answers."""
    dist = np.asarray(dist)
    return np.where(dist >= 0, dist, n).astype(dist.dtype), cnt


def narrow(dtypes) -> int:
    """How many of the count arrays, given by their numpy or torch
    dtypes, are not int64."""
    return sum(str(d).replace("torch.", "") != "int64" for d in dtypes)


def verdict(numbers: dict, pairs_checked: int) -> bool:
    """True when every number is within its limit and something was
    checked."""
    return pairs_checked > 0 and all(
        numbers[k] <= LIMITS[k] for k in numbers)


def lines(numbers: dict, pairs_checked: int) -> list:
    """One line per number compared, beside its limit."""
    out = [f"check {k} {v} limit {LIMITS[k]}" for k, v in numbers.items()]
    return out + [f"check pairs_checked {pairs_checked} limit >0"]
