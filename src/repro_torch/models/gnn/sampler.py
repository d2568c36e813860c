"""K-hop neighbour sampler (GraphSAGE-style) for the ``minibatch_lg`` shape.

Port of ``repro.models.gnn.sampler``: host-side numpy over a CSR
adjacency, the reference's draws line for line, so the same (seed, step)
gives the same block.  Each block is a fixed-shape padded ``GraphBatch``:

* layer capacities are ``batch_nodes * prod(fanout[:i])``;
* sampled subgraphs smaller than capacity are dump-padded;
* features are gathered on the host, then the block is placed on
  ``device`` by the port's ``from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.graph import from_numpy


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR adjacency."""
    indptr: np.ndarray   # int64[n + 1]
    indices: np.ndarray  # int32[m]
    feat: np.ndarray     # float32[n, d]
    labels: np.ndarray   # int32[n]

    @property
    def n(self) -> int:
        return len(self.indptr) - 1


def synthetic_csr(n: int, avg_deg: int, d_feat: int, n_classes: int = 41,
                  seed: int = 0) -> CSRGraph:
    """Power-law-ish synthetic graph in CSR (host RAM only)."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured degree skew
    deg = np.minimum(
        rng.zipf(1.7, size=n).astype(np.int64), 50 * avg_deg)
    deg = np.maximum((deg * avg_deg / max(deg.mean(), 1)).astype(np.int64), 1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    m = int(indptr[-1])
    indices = rng.integers(0, n, size=m).astype(np.int32)
    feat = rng.normal(size=(n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    return CSRGraph(indptr=indptr, indices=indices, feat=feat, labels=labels)


def sample_block_caps(batch_nodes: int, fanout: Sequence[int]):
    """(node_cap, edge_cap) of the padded sampled subgraph."""
    node_cap = batch_nodes
    edge_cap = 0
    layer = batch_nodes
    for f in fanout:
        edge_cap += layer * f
        layer *= f
        node_cap += layer
    return node_cap, edge_cap


class NeighborSampler:
    """Uniform k-hop fanout sampler producing padded GraphBatch blocks."""

    def __init__(self, g: CSRGraph, batch_nodes: int, fanout: Sequence[int],
                 seed: int = 0):
        self.g = g
        self.batch_nodes = batch_nodes
        self.fanout = tuple(fanout)
        self.seed = seed
        self.node_cap, self.edge_cap = sample_block_caps(batch_nodes, fanout)

    def sample(self, step: int, device="cuda"):
        """Returns (GraphBatch on ``device``, target_labels int32
        [batch_nodes], target_slots int32[batch_nodes]), the last two on
        ``device`` too."""
        dev = resolve_device(device)
        rng = np.random.default_rng((self.seed, step))
        g = self.g
        targets = rng.integers(0, g.n, size=self.batch_nodes).astype(np.int64)

        # node dedup table: global id -> local slot
        local = {}
        order = []

        def slot(v: int) -> int:
            s = local.get(v)
            if s is None:
                s = len(order)
                local[v] = s
                order.append(v)
            return s

        for v in targets:
            slot(int(v))
        senders, receivers = [], []
        frontier = [int(v) for v in targets]
        for f in self.fanout:
            nxt = []
            for v in frontier:
                lo, hi = g.indptr[v], g.indptr[v + 1]
                if hi == lo:
                    continue
                nbrs = g.indices[lo + rng.integers(0, hi - lo, size=f)]
                for u in nbrs:
                    u = int(u)
                    senders.append(slot(u))
                    receivers.append(local[v])
                    nxt.append(u)
            frontier = nxt
        n_used = len(order)
        ids = np.asarray(order, dtype=np.int64)
        feat = np.zeros((self.node_cap, g.feat.shape[1]), np.float32)
        feat[:n_used] = g.feat[ids]
        # pad node table to capacity; dump-row handled by from_numpy
        batch = from_numpy(
            feat,
            np.asarray(senders, np.int32),
            np.asarray(receivers, np.int32),
            e_cap=self.edge_cap, device=dev,
        )
        labels = g.labels[targets].astype(np.int32)
        slots = np.arange(self.batch_nodes, dtype=np.int32)  # targets first
        return (batch, torch.from_numpy(labels).to(dev),
                torch.from_numpy(slots).to(dev))


__all__ = ["CSRGraph", "NeighborSampler", "sample_block_caps",
           "synthetic_csr"]
