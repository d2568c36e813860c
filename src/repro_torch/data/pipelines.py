"""Deterministic synthetic graphs and update streams (host-side numpy).

The port's own copies of ``random_graph_edges`` and ``graph_stream``
from ``repro.data.pipelines``: the same seeds give the same edge lists
and event streams as the reference, so the parity tests feed both
packages identical inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def random_graph_edges(n: int, m: int, seed: int = 0,
                       power_law: bool = True) -> list[Tuple[int, int]]:
    """Undirected simple graph edge list; power-law degree skew
    (w_i proportional to i^-0.8) matches the paper's web/social graphs."""
    rng = np.random.default_rng(seed)
    edges: set[Tuple[int, int]] = set()
    if power_law:
        w = 1.0 / (np.arange(1, n + 1) ** 0.8)
        w /= w.sum()
    tries = 0
    while len(edges) < m and tries < 50 * m:
        tries += 1
        if power_law:
            a, b = rng.choice(n, size=2, p=w)
        else:
            a, b = rng.integers(0, n, size=2)
        if a == b:
            continue
        edges.add((min(int(a), int(b)), max(int(a), int(b))))
    return sorted(edges)


def graph_stream(edges: Sequence[Tuple[int, int]], n: int,
                 n_insert: int, n_delete: int, seed: int = 0):
    """Mixed update stream (Section 4.4): a list of ('+'/'-', a, b).

    Inserted edges are fresh non-edges; deletions pick existing edges
    (including freshly inserted ones), mirroring the paper's protocol.
    """
    rng = np.random.default_rng(seed)
    present = set(edges)
    events = []
    ops = ["+"] * n_insert + ["-"] * n_delete
    rng.shuffle(ops)
    for op in ops:
        if op == "+":
            while True:
                a, b = rng.integers(0, n, size=2)
                key = (min(int(a), int(b)), max(int(a), int(b)))
                if a != b and key not in present:
                    present.add(key)
                    events.append(("+", key[0], key[1]))
                    break
        else:
            if not present:
                continue
            idx = rng.integers(0, len(present))
            key = sorted(present)[idx]
            present.discard(key)
            events.append(("-", key[0], key[1]))
    return events
