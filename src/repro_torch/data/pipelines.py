"""Deterministic synthetic batches, graphs, update streams and molecules
(host-side numpy, keyed by ``(seed, step)`` where a step has one).

The port's own copies of ``lm_batch``, ``dien_batch``,
``random_graph_edges``, ``graph_stream`` and ``molecule_batch`` from
``repro.data.pipelines``: the same seeds give the same token streams,
recsys batches, edge lists, event streams and molecule batches as the
reference, so the parity tests feed both packages identical inputs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


# -------------------------------------------------------------------------
# LM token stream
# -------------------------------------------------------------------------
def lm_batch(step: int, batch: int, seq: int, vocab: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Zipf(1.3) tokens clipped to the vocabulary, int32 [batch, seq],
    with the next-token labels."""
    rng = np.random.default_rng((seed, step))
    toks = rng.zipf(1.3, size=(batch, seq + 1))
    toks = np.minimum(toks - 1, vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :seq], "labels": toks[:, 1:]}


# -------------------------------------------------------------------------
# DIEN batches
# -------------------------------------------------------------------------
def dien_batch(step: int, batch: int, seq_len: int, n_items: int,
               n_cates: int, n_profile_vocab: int, bags: int = 4,
               bag_size: int = 8, seed: int = 0) -> Dict[str, np.ndarray]:
    """One DIEN batch: histories of 1..seq_len valid steps (a prefix
    mask), targets, profile bags, sampled negatives and 0/1 labels."""
    rng = np.random.default_rng((seed, step))
    lengths = rng.integers(1, seq_len + 1, size=batch)
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    return {
        "hist_items": rng.integers(0, n_items, (batch, seq_len)).astype(np.int32),
        "hist_cates": rng.integers(0, n_cates, (batch, seq_len)).astype(np.int32),
        "hist_mask": mask,
        "target_item": rng.integers(0, n_items, (batch,)).astype(np.int32),
        "target_cate": rng.integers(0, n_cates, (batch,)).astype(np.int32),
        "profile": rng.integers(0, n_profile_vocab,
                                (batch, bags, bag_size)).astype(np.int32),
        "neg_items": rng.integers(0, n_items, (batch, seq_len)).astype(np.int32),
        "neg_cates": rng.integers(0, n_cates, (batch, seq_len)).astype(np.int32),
        "label": rng.integers(0, 2, (batch,)).astype(np.int32),
    }


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


# -------------------------------------------------------------------------
# Batched small molecules (GNN ``molecule`` shape)
# -------------------------------------------------------------------------
def molecule_batch(step: int, batch: int, n_nodes: int, n_edges: int,
                   d_feat: int, seed: int = 0):
    """Random 3D point-cloud molecules with kNN-ish bonded edges.

    Returns dict of numpy arrays ready for ``gnn.graph.from_numpy``
    (concatenated disjoint union of ``batch`` graphs).
    """
    rng = np.random.default_rng((seed, step))
    feats, poss, snds, rcvs, gids = [], [], [], [], []
    for g in range(batch):
        pos = rng.normal(scale=2.0, size=(n_nodes, 3)).astype(np.float32)
        # connect each node to its nearest neighbours until n_edges reached
        d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        order = np.argsort(d2, axis=1)
        s, r = [], []
        k = 0
        while len(s) < n_edges:
            for i in range(n_nodes):
                if len(s) >= n_edges:
                    break
                j = int(order[i, k % (n_nodes - 1)])
                s.append(i)
                r.append(j)
            k += 1
        base = g * n_nodes
        feats.append(rng.normal(size=(n_nodes, d_feat)).astype(np.float32))
        poss.append(pos)
        snds.extend(base + np.asarray(s[:n_edges]))
        rcvs.extend(base + np.asarray(r[:n_edges]))
        gids.extend([g] * n_nodes)
    return {
        "node_feat": np.concatenate(feats, 0),
        "pos": np.concatenate(poss, 0),
        "senders": np.asarray(snds, np.int32),
        "receivers": np.asarray(rcvs, np.int32),
        "graph_id": np.asarray(gids, np.int32),
        "n_graph": batch,
        "targets": rng.normal(size=(batch, 1)).astype(np.float32),
    }
