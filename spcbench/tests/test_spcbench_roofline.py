"""The query kernel's byte count on hand-counted cases."""

import numpy as np

from spcbench import roofline


def test_repeated_rows_counted_once():
    sizes = np.array([3, 5, 7, 11])
    # rows 0, 1 and 2 are touched, row 0 four times (as source and target)
    got = roofline.k1_bytes(sizes, [0, 0, 1], [0, 2, 0])
    assert got == 16 * (3 + 5 + 7) + 8 * 6 + 12 * 3


def test_padded_entries_not_counted():
    """Only a row's used entries count, whatever its capacity."""
    sizes = np.array([2, 0, 9])
    assert roofline.k1_bytes(sizes, [0], [1]) == 16 * 2 + 8 * 2 + 12


def test_least_seconds_at_hbm_rate():
    assert roofline.least_seconds(3.35e12) == 1.0
