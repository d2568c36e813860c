#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--halvings K] [--seed S]

Phases, each reported on its own line(s):

1. device    -- the card's name and power limit (``nvidia-smi``).
2. build     -- compiles every CUDA kernel from the sources under
                ``src/repro_torch/csrc`` (one ``nvcc`` per source,
                started together) and prints the build seconds.
3. kernels   -- holds each kernel against its plain PyTorch version on
                the card.  spc_query exactly (integer outputs): the TPU
                sweep shapes, hand-made rows with counts 2^24 + 1 and
                above 2^32, and 1024 pairs gathered from the built index.
                embedding_bag within rtol = atol = 1e-6 in float32 (only
                the fp32 summation order differs) and 1e-2 in bfloat16
                against the float32 sum of the same bfloat16 rows: the
                TPU sweep shapes, the
                recsys shapes of ``configs/dien.py`` (vocab 100000,
                D = 18, 8 ids per bag, 512 x 4 and 262144 x 4 bags) and
                the re-rank's own bags.  The main-path shapes are checked
                and timed after phase A2.
4. build     -- ``DynamicSPC(..., device="cuda", construct_batch=32,
                l_cap=None)`` on a power-law graph at the ``dspc``
                configuration's scale (n = 65536, m = 524288, weights
                proportional to i^-0.8), halved ``--halvings`` times.
A1. analytics, pinned before the chunk -- attaches a ``SnapshotStore``,
                seeds ``TopKBetweenness`` (512 sampled pairs x all n
                candidates) and pins a snapshot, keeping a copy of it.
5. maintain  -- one ``apply_events`` chunk of the configuration's
                update_batch = 64 events (32 inserts, 32 deletes from
                ``graph_stream``); it publishes into the store.
6. serve     -- 64 batches of 1024 random pairs through
                ``QueryEngine(route="auto")`` (the kernel route on the
                card), then the same batches on the plain-torch merge
                route; both must agree.
A2. analytics after the chunk -- refreshes the maintainer (and times a
                full recompute on the same snapshot beside it), checks
                the pinned snapshot is byte-identical to its copy, counts
                shortest cycles through the top-betweenness vertex,
                recommends friends for the user with the largest label
                row and re-ranks them with a PNA forward pass (the
                ``configs/pna.py`` CONFIG width) over the ego net plus
                ``embedding_bag`` mean pooling of the common-friend ids.
7. oracles   -- ``plain_spc_bfs`` on the current graph equals the
                engine's (dist, count) for 8 sampled sources (after
                phases 4 and 5); the maintained betweenness equals the
                BFS pair dependencies from every pair endpoint (rtol =
                atol = 1e-9, after phases 4 and 5); cycle and
                recommendation counts equal those taken from the edge
                list; the card's re-rank equals the same forward on the
                CPU (rtol 1e-4, atol 1e-5).

Launches are counted for each main path on its own: the DSPC path
(phases 4, 5, 6) and the analytics path (the timed steps of A1 and A2).
The launch counters are set to 0 just before each of these phases and
read just after it; the oracles and the kernel checks run outside them
and count nowhere.  Each path must have launched each of its kernels
(``PATH_KERNELS``).  The line before the last is a JSON object with one
entry per kernel (its time on the card, its plain version's time, its
bound, one library call's time where there is one, its launches on the
main paths, also by path); the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero.  Without a CUDA
device, or without the repository's sources beside it, the script exits
1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
#: 32-bit scalar operations per second outside the tensor cores (the
#: fp32 rate; integer compares and adds issue at no more than it).
SCALAR_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "spc_query": ("src/repro_torch/csrc/spc_query.cu",
                  "src/repro/kernels/spc_query/kernel.py:38"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:29"),
}

#: The kernels each main path must launch.
PATH_KERNELS = {"dspc": ("spc_query",), "analytics": ("embedding_bag",)}

#: The TPU sweep of tests/kernels/test_kernels.py (b, s, v, d), and the
#: recsys shapes of configs/dien.py: vocab 100000, D = 18, 8 ids per
#: bag, 4 bags per example at serve_p99 (512) and serve_bulk (262144).
BAG_SWEEP = ((4, 3, 16, 128), (32, 20, 1000, 16), (7, 1, 64, 32))
BAG_RECSYS = (("serve_p99", 512 * 4), ("serve_bulk", 262144 * 4))
RECSYS_VOCAB, RECSYS_DIM, RECSYS_BAG = 100_000, 18, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, from CUDA events (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def power_law_edges(n: int, m: int, seed: int) -> list:
    """m distinct undirected edges, endpoints drawn with weights
    proportional to i^-0.8 (the weights of
    ``repro_torch.data.random_graph_edges``), drawn in bulk."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(1, n + 1) ** 0.8)
    cdf = np.cumsum(w / w.sum())
    keys = np.empty(0, dtype=np.int64)
    while keys.shape[0] < m:
        k = 2 * (m - keys.shape[0]) + 1024
        ab = np.minimum(np.searchsorted(cdf, rng.random((k, 2))), n - 1)
        lo, hi = ab.min(axis=1), ab.max(axis=1)
        fresh = (lo * n + hi)[lo != hi]
        allk = np.concatenate([keys, fresh])
        _, first = np.unique(allk, return_index=True)
        keys = allk[np.sort(first)]          # first occurrences, in order
    keys = np.sort(keys[:m])
    return list(zip((keys // n).tolist(), (keys % n).tolist()))


def sweep_rows(b: int, l_cap: int, n: int, rng, device):
    """Kernel-ready rows: sorted distinct hubs per row, s side padded
    with n, t side with n + 1, pad dist INF, pad cnt 0."""
    import torch
    INF = 1 << 28
    out = []
    for pad in (n, n + 1):
        hub = np.full((b, l_cap), pad, dtype=np.int32)
        dist = np.full((b, l_cap), INF, dtype=np.int32)
        cnt = np.zeros((b, l_cap), dtype=np.int64)
        for r in range(b):
            k = int(rng.integers(0, l_cap + 1))
            hub[r, :k] = np.sort(rng.choice(n, size=k, replace=False))
            dist[r, :k] = rng.integers(0, 12, k)
            cnt[r, :k] = rng.integers(1, 9, k)
        out += [hub, dist, cnt]
    return tuple(torch.from_numpy(x).to(device) for x in out)


def big_count_rows(device):
    """Hand-made rows whose counts are 2^24 + 1 and above 2^32 (the
    fp32 TPU kernel rounds the first; the second overflows int32)."""
    import torch
    INF = 1 << 28
    n = 3
    big24, big32 = 2 ** 24 + 1, 2 ** 33 + 3
    # row 2: all three common hubs tie at distance 4
    hub_s = [[0, n, n, n], [0, 1, n, n], [0, 1, 2, n]]
    dist_s = [[0, INF, INF, INF], [1, 0, INF, INF], [2, 3, 4, INF]]
    cnt_s = [[1, 0, 0, 0], [big24, 1, 0, 0], [big32, 5, 1, 0]]
    hub_t = [[0, 1, n + 1, n + 1], [0, 2, n + 1, n + 1], [0, 1, 2, n + 1]]
    dist_t = [[1, 0, INF, INF], [2, 0, INF, INF], [2, 1, 0, INF]]
    cnt_t = [[big24, 1, 0, 0], [7, 1, 0, 0], [3, 1, 1, 0]]
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dts = (torch.int32, torch.int32, torch.int64) * 2
    want = ([1, 3, 4], [big24, big24 * 7, big32 * 3 + 5 + 1])
    return (tuple(torch.tensor(r, dtype=dt, device=device)
                  for r, dt in zip(rows, dts)), want)


def spc_query_work(rows):
    """(bytes, operations) that the spc_query function needs on these
    rows.  Bytes: both hub rows in full (where a row's labels end is only
    known by reading it), dist and cnt of either side only at the common
    hubs (4 + 4 + 8 + 8 bytes each), and the outputs (4 + 8 bytes per
    pair).  Operations: a sorted merge, one compare per real label of
    either row, plus an add, a compare, a multiply and an add per common
    hub."""
    import torch
    INF = 1 << 28
    hub_s, dist_s, _, hub_t, dist_t, _ = rows
    b, l_cap = hub_s.shape
    pos = torch.searchsorted(hub_t, hub_s).clamp_(max=l_cap - 1)
    common = int((hub_t.gather(1, pos) == hub_s).sum())   # pads never match
    real = int((dist_s < INF).sum() + (dist_t < INF).sum())
    nbytes = (hub_s.numel() * hub_s.element_size()
              + hub_t.numel() * hub_t.element_size()
              + 24 * common + b * (4 + 8))
    return nbytes, real + 4 * common, common


def check_equal(tag, got, want):
    """Exact equality of (dist, count) tensors; returns max |diff|."""
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
    if err:
        raise AssertionError(f"{tag}: kernel and plain version differ "
                             f"(max |diff| {err})")
    return err


def oracle(svc, engine, sources, tag):
    """plain_spc_bfs from each source == the engine's answers to all v."""
    import torch
    from repro_torch.core.bfs import plain_spc_bfs
    n = svc.n
    t0 = time.monotonic()
    targets = np.arange(n)
    for s in sources:
        res = plain_spc_bfs(svc.graph, int(s))
        d, c = engine.query_batch(svc.index, np.full(n, s), targets)
        if not (torch.equal(d, res.dist[:n]) and torch.equal(c, res.cnt[:n])):
            bad = int(((d != res.dist[:n]) | (c != res.cnt[:n])).nonzero()[0])
            raise AssertionError(
                f"oracle {tag}: source {s} target {bad}: engine "
                f"({int(d[bad])}, {int(c[bad])}) vs BFS "
                f"({int(res.dist[bad])}, {int(res.cnt[bad])})")
    log(f"oracle[{tag}]: {len(sources)} sources x {n} targets equal to "
        f"plain_spc_bfs ({time.monotonic() - t0:.3f} s)")


class PathLaunches:
    """Kernel launches on each main path.  ``with launches.path(name):``
    sets every wrapper's count to 0 just before the enclosed phase and
    adds what it reads just after to that path's tally; launches made
    outside such a block (oracles, kernel checks) count nowhere."""

    def __init__(self, counters):
        self.counters = counters                 # kernel name -> counter
        self.by_path = {p: dict.fromkeys(counters, 0) for p in PATH_KERNELS}

    @contextlib.contextmanager
    def path(self, name):
        for c in self.counters.values():
            c.count = 0
        yield
        for k, c in self.counters.items():
            self.by_path[name][k] += c.count

    def check(self):
        """Raise unless every path launched each of its kernels."""
        for p, kernels in PATH_KERNELS.items():
            for k in kernels:
                if self.by_path[p][k] == 0:
                    raise AssertionError(f"kernel {k} never launched on "
                                         f"the {p} path")

    def of(self, kernel):
        """(launches over the main paths, launches by path)."""
        by = {p: c[kernel] for p, c in self.by_path.items()}
        return sum(by.values()), by


def bag_inputs(b: int, s: int, v: int, d: int, rng, device):
    """ids int32 [b, s] uniform over [0, v) and a float32 table
    [v + 1, d] whose last row is zero (the shape the ops wrapper hands
    the kernel)."""
    import torch
    ids = torch.from_numpy(rng.integers(0, v, (b, s)).astype(np.int32))
    table = rng.standard_normal((v + 1, d)).astype(np.float32)
    table[v] = 0.0
    return ids.to(device), torch.from_numpy(table).to(device)


def embedding_bag_work(ids, table):
    """(bytes, operations, distinct rows) that the embedding_bag function
    needs on these inputs.  Bytes: the ids, each distinct table row the
    bags touch once, and the output.  Operations: one add per id and
    column."""
    import torch
    b, s = ids.shape
    v1, d = table.shape
    rows = torch.where((ids >= 0) & (ids < v1 - 1), ids, v1 - 1)
    distinct = int(torch.unique(rows).numel())
    elem = table.element_size()
    nbytes = ids.numel() * ids.element_size() + (distinct + b) * d * elem
    return nbytes, b * s * d, distinct


def check_close(tag, got, want, rtol, atol):
    """allclose in float64 on the card; returns max |got - want|."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{tag}: non-finite output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: max |diff| {err} beyond rtol {rtol}, "
                             f"atol {atol}")
    return err


def bound_ms(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the peak rate."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def live_edges(graph):
    """Live directed edge slots (src, dst) of the card's edge list."""
    src, dst = graph.src[:graph.m2].long(), graph.dst[:graph.m2].long()
    live = src != graph.n
    return src[live], dst[live]


def bfs_betweenness(graph, pairs_s, pairs_t):
    """Pair dependencies of every vertex, float64 [n], from one
    ``plain_spc_bfs`` per distinct pair endpoint (no labels): the
    oracle of the maintained betweenness."""
    import torch
    from repro_torch.core.bfs import plain_spc_bfs
    n = graph.n
    rows = {int(u): plain_spc_bfs(graph, int(u))
            for u in np.unique(np.concatenate([pairs_s, pairs_t]))}
    vs = torch.arange(n, device=graph.device)
    bc = torch.zeros(n, dtype=torch.float64, device=graph.device)
    for s, t in zip(pairs_s.tolist(), pairs_t.tolist()):
        ds, cs = rows[s].dist[:n].long(), rows[s].cnt[:n]
        dt, ct = rows[t].dist[:n].long(), rows[t].cnt[:n]
        d_st = int(ds[t])
        if d_st >= (1 << 28):
            continue
        on = (ds + dt == d_st) & (vs != s) & (vs != t)
        bc += torch.where(on, cs.double() * ct.double() / float(cs[t]), 0.0)
    return bc


def edge_list_cycles(graph, v: int):
    """(triangles, quadrilaterals) through ``v`` counted from the edge
    list: edges inside N(v), and C(c[x], 2) over x != v where c[x] is
    the number of neighbours of v adjacent to x."""
    import torch
    src, dst = live_edges(graph)
    nb = torch.zeros(graph.n, dtype=torch.bool, device=src.device)
    nb[dst[src == v]] = True
    tri = int((nb[src] & nb[dst]).sum()) // 2
    c = torch.bincount(dst[nb[src]], minlength=graph.n)
    c[v] = 0
    return tri, int((c * (c - 1) // 2).sum())


def edge_list_recommend(graph, u: int, k: int):
    """Top-k (vertex, common-friend count) of ``u`` from the edge list,
    by count desc, id asc."""
    import torch
    src, dst = live_edges(graph)
    nb = torch.zeros(graph.n, dtype=torch.bool, device=src.device)
    nb[dst[src == u]] = True
    c = torch.bincount(dst[nb[src]], minlength=graph.n)
    c[nb] = 0
    c[u] = 0
    cand = c.nonzero()[:, 0].cpu().numpy()
    score = c.cpu().numpy()[cand]
    order = np.lexsort((cand, -score))[:k]
    return [(int(cand[i]), int(score[i])) for i in order]


def ego_batch(view, u, candidates, d_in, device):
    """Padded GraphBatch over {u} + N(u) + candidates, features from the
    pinned snapshot only (the glue of examples/analytics_spc.py)."""
    from repro_torch.analytics import neighbors
    from repro_torch.models.gnn.graph import from_numpy
    nbrs = neighbors(view.index, u)
    sub = np.unique(np.concatenate([[u], nbrs, candidates]))
    local = {int(v): i for i, v in enumerate(sub)}
    senders, receivers = [], []
    for v in sub:
        for w in neighbors(view.index, int(v)):
            if int(w) in local:             # keep edges inside the ego net
                senders.append(local[int(v)])
                receivers.append(local[int(w)])
    feats = view.recommendation_features(u, sub)[:, :d_in]
    batch = from_numpy(feats.astype(np.float32),
                       np.asarray(senders, dtype=np.int64),
                       np.asarray(receivers, dtype=np.int64), device=device)
    return batch, sub, local


def common_friend_bags(view, u, cand):
    """int32 [C, width] common-friend ids of each candidate, padded with
    the id n (width at least 1)."""
    ids = [view.common_neighbor_ids(u, int(x)) for x in cand]
    width = max(max(len(i) for i in ids), 1)
    padded = np.full((len(cand), width), view.n, dtype=np.int32)
    for row, i in zip(padded, ids):
        row[:len(i)] = i
    return padded


def rerank(view, u, recs, pna, table):
    """Section 3 of examples/analytics_spc.py on the port: PNA node
    scores over the ego net plus the mean-pooled embeddings of each
    candidate's common friends.  Runs where ``pna`` and ``table`` lie.
    Returns (candidates, model scores float64 [C], ego-net size)."""
    import torch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    dev = table.device
    cand = np.asarray([r.vertex for r in recs])
    batch, sub, local = ego_batch(view, u, cand, pna.cfg.d_in, dev)
    with torch.no_grad():
        node_scores = pna(batch)[:, 0]
    bags = torch.from_numpy(common_friend_bags(view, u, cand)).to(dev)
    pooled = embedding_bag(bags, table, mode="mean", pad_id=view.n)
    rows = torch.as_tensor([local[int(x)] for x in cand], device=dev)
    model = node_scores[rows] + pooled.mean(dim=1)
    return cand, model.double().cpu().numpy(), len(sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--halvings", type=int, default=0,
                    help="halve the dspc CONFIG's n and m this many times")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.analytics import AnalyticsEngine, CycleCount
    from repro_torch.configs.dspc import CONFIG
    from repro_torch.configs.pna import CONFIG as PNA_CONFIG
    from repro_torch.core import bfs as B
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.core.graph import INF
    from repro_torch.core.query import merge_rows
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.spc_query import kernel as K
    from repro_torch.kernels.spc_query.ops import prep_rows
    from repro_torch.kernels.spc_query.ref import spc_query_ref
    from repro_torch.models.gnn.pna import PNA
    from repro_torch.serve.engine import QueryEngine

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    secs = common.build(list(KERNEL_SOURCES))
    log(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())} "
        f"(wall {time.monotonic() - t0:.2f} s)")
    for name, text in common.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  nvcc[{name}]: {line.strip()}")

    # -- 3a. kernels vs plain on synthetic inputs -------------------------
    max_err = 0
    for b, l_cap in ((4, 8), (130, 16), (256, 32), (17, 128)):
        rows = sweep_rows(b, l_cap, max(50, 2 * l_cap), rng, dev)
        got = K.spc_query_cuda(*rows)
        torch.cuda.synchronize()
        max_err = max(max_err, check_equal(f"sweep({b},{l_cap})", got,
                                           spc_query_ref(*rows)))
    rows, want = big_count_rows(dev)
    got = K.spc_query_cuda(*rows)
    torch.cuda.synchronize()
    max_err = max(max_err, check_equal("big counts", got,
                                       spc_query_ref(*rows)))
    if got[0].tolist() != want[0] or got[1].tolist() != want[1]:
        raise AssertionError(f"big counts: {got} != {want}")
    log(f"kernels: spc_query == plain on the sweep and on counts "
        f"{want[1]} (exact)")

    bag_err, bag_shapes = 0.0, []
    for tag, (b, s, v, d) in ([(f"sweep{shape}", shape)
                               for shape in BAG_SWEEP]
                              + [(name, (b, RECSYS_BAG, RECSYS_VOCAB,
                                         RECSYS_DIM))
                                 for name, b in BAG_RECSYS]):
        ids, table = bag_inputs(b, s, v, d, rng, dev)
        truth = embedding_bag_ref(ids, table)
        got = EB.embedding_bag_cuda(ids, table)
        torch.cuda.synchronize()
        bag_err = max(bag_err, check_close(f"embedding_bag {tag} f32", got,
                                           truth, 1e-6, 1e-6))
        table16 = table.to(torch.bfloat16)
        got16 = EB.embedding_bag_cuda(ids, table16)
        torch.cuda.synchronize()
        check_close(f"embedding_bag {tag} bf16", got16,
                    embedding_bag_ref(ids, table16.float()), 1e-2, 1e-2)
        if tag.startswith("sweep"):
            continue
        lib = F.embedding_bag(ids, table, mode="sum")
        check_close(f"F.embedding_bag {tag}", lib, truth, 1e-5, 1e-5)
        nbytes, ops, distinct = embedding_bag_work(ids, table)
        bound, by = bound_ms(nbytes, ops)
        bag_shapes.append({
            "shape": tag, "bags": b, "ids_per_bag": s, "rows": v + 1,
            "dim": d, "distinct_rows": distinct,
            "ms": cuda_ms(lambda: EB.embedding_bag_cuda(ids, table), 50),
            "bf16_ms": cuda_ms(lambda: EB.embedding_bag_cuda(ids, table16),
                               50),
            "plain_ms": cuda_ms(lambda: embedding_bag_ref(ids, table), 10),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                ids, table, mode="sum"), 50),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes})
        log(f"embedding_bag {tag}: {json.dumps(bag_shapes[-1])}")
    log(f"kernels: embedding_bag == plain on the sweep and the recsys "
        f"shapes (f32 max |diff| {bag_err:.3g}; bf16 within 1e-2)")

    # -- 4. main paths: build --------------------------------------------------
    n, m = CONFIG.n >> args.halvings, CONFIG.m >> args.halvings
    reduced = [f"n {CONFIG.n}->{n}", f"m {CONFIG.m}->{m}"] \
        if args.halvings else []
    t0 = time.monotonic()
    edges = power_law_edges(n, m, args.seed)
    log(f"graph: n={n} m={len(edges)} power-law w~i^-0.8 "
        f"({time.monotonic() - t0:.2f} s on the host)")
    log(f"reduced: {json.dumps(reduced)}")
    counts = PathLaunches({"spc_query": K.launches,
                           "embedding_bag": EB.launches})
    B.frontier_syncs.count = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with counts.path("dspc"):
        svc = DynamicSPC(n, edges, device="cuda", l_cap=None,
                         construct_batch=CONFIG.construct_batch,
                         vertex_order=CONFIG.vertex_order)
        torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    log(f"build: {build_s:.3f} s, l_cap {svc.index.l_cap}, "
        f"{svc.index_entries()} label entries "
        f"(max {int(svc.index.size.max())}/row), {svc.index_bytes()} index "
        f"bytes, label regrows {svc.stats.label_regrows}, host syncs "
        f"{B.frontier_syncs.count}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    engine = QueryEngine(route="auto")
    sources = rng.choice(n, size=8, replace=False)
    oracle(svc, engine, sources, "after build")

    # -- A1. analytics pinned before the chunk ----------------------------------
    store = svc.attach_store()
    ana = AnalyticsEngine.from_config(store, CONFIG)
    pairs = ana.sample_pairs()
    t0 = time.monotonic()
    with counts.path("analytics"):
        maint = ana.betweenness_maintainer(pairs)
        pinned = ana.pin()
    seed_s = time.monotonic() - t0
    frozen = {f.name: getattr(pinned.index, f.name).clone()
              for f in dataclasses.fields(pinned.index) if f.name != "n"}
    log(f"analytics: store v{store.version}; TopKBetweenness over "
        f"{len(pairs[0])} pairs x {n} candidates seeded in {seed_s:.3f} s "
        f"(top 3 {maint.top(3)})")
    t0 = time.monotonic()
    bc_err = check_close(
        "betweenness after build", torch.from_numpy(maint.scores()).to(dev),
        bfs_betweenness(svc.graph, *pairs), 1e-9, 1e-9)
    log(f"oracle[betweenness after build]: equal to the BFS pair "
        f"dependencies of {len(np.unique(np.concatenate(pairs)))} "
        f"endpoints (max |diff| {bc_err:.3g}; "
        f"{time.monotonic() - t0:.3f} s)")

    # -- 5. maintain --------------------------------------------------------
    half = CONFIG.update_batch // 2
    events = graph_stream(edges, n, half, half, seed=args.seed)
    syncs0 = B.frontier_syncs.count
    regrows0 = svc.stats.label_regrows
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with counts.path("dspc"):
        svc.apply_events(events, batch_size=CONFIG.update_batch)
        torch.cuda.synchronize()
    st = svc.stats.snapshot()
    log(f"maintain: {len(events)} events in {st.batches} chunk(s), "
        f"{time.monotonic() - t0:.3f} s, inserts {st.inserts}, deletions "
        f"{st.deletions}, label regrows {st.label_regrows - regrows0}, edge "
        f"regrows {st.edge_regrows}, host syncs {B.frontier_syncs.count - syncs0}, "
        f"l_cap {svc.index.l_cap}, store v{store.version}")
    oracle(svc, engine, sources, "after events")

    # -- 6. serve -----------------------------------------------------------
    batches = [(rng.integers(0, n, 1024), rng.integers(0, n, 1024))
               for _ in range(64)]
    served = {}
    for route in ("auto", "merge"):
        eng = QueryEngine(route=route)
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(65)]
        outs = []
        with counts.path("dspc"):
            eng.query_batch(svc.index, *batches[0])      # warm-up
            torch.cuda.synchronize()
            t0 = time.monotonic()
            evs[0].record()
            for k, (s, t) in enumerate(batches):
                outs.append(eng.query_batch(svc.index, s, t))
                evs[k + 1].record()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        us = [1e3 * evs[k].elapsed_time(evs[k + 1]) for k in range(64)]
        served[route] = outs
        log(f"serve[{route}]: routes {dict(eng.stats.snapshot().routes)}, "
            f"per-batch us p50 {np.percentile(us, 50):.1f} p90 "
            f"{np.percentile(us, 90):.1f} max {max(us):.1f}, "
            f"{64 * 1024 / wall:.1f} qps ({wall:.4f} s)")
        if route == "auto" and dict(eng.stats.routes) != {"kernel": 65}:
            raise AssertionError(f"auto did not take the kernel route: "
                                 f"{eng.stats.routes}")
    for (d0, c0), (d1, c1) in zip(served["auto"], served["merge"]):
        if not (torch.equal(d0, d1) and torch.equal(c0, c1)):
            raise AssertionError("serve: kernel and merge routes differ")
    log("serve: kernel and merge routes agree on all 64 batches")

    # -- A2. analytics after the chunk --------------------------------------
    cfg = dataclasses.replace(PNA_CONFIG, d_in=4)
    pna = PNA(cfg, generator=torch.Generator().manual_seed(args.seed),
              device=dev)
    table = torch.from_numpy(np.random.default_rng(args.seed + 1)
                             .standard_normal((n, 8)).astype(np.float32))
    table_dev = table.to(dev)
    inc0 = maint.incremental_refreshes
    step_s = {}
    with counts.path("analytics"):
        t0 = time.monotonic()
        maint.refresh()
        step_s["refresh"] = time.monotonic() - t0
        view = ana.pin()
        hot = maint.top(1)[0][0]
        t0 = time.monotonic()
        cyc = view.cycles_through_vertex(hot)
        step_s["cycles"] = time.monotonic() - t0
        u = int(view.index.size[:n].argmax())
        t0 = time.monotonic()
        recs = view.recommend(u)
        step_s["recommend"] = time.monotonic() - t0
        t0 = time.monotonic()
        cand, model, sub_n = rerank(view, u, recs, pna, table_dev)
        step_s["rerank"] = time.monotonic() - t0

    how = "incremental" if maint.incremental_refreshes > inc0 else "full"
    log(f"analytics: refresh to v{maint.version} in {step_s['refresh']:.3f} s, "
        f"{how}, last_changed {maint.last_changed} of {n} rows (top 3 "
        f"{maint.top(3)})")
    if maint.version != store.version:
        raise AssertionError(f"maintainer at v{maint.version}, store at "
                             f"v{store.version}")
    t0 = time.monotonic()
    full = view.betweenness(pairs=pairs)
    full_s = time.monotonic() - t0
    full_err = check_close("refresh vs full recompute",
                           torch.from_numpy(maint.scores()),
                           torch.from_numpy(full), 1e-9, 1e-9)
    log(f"analytics: a full recompute on the same snapshot takes "
        f"{full_s:.3f} s ({full_s / step_s['refresh']:.2f}x the refresh); "
        f"max |diff| {full_err:.3g}")
    for name, want in frozen.items():
        if not torch.equal(getattr(pinned.index, name), want):
            raise AssertionError(f"pinned snapshot v{pinned.version}: "
                                 f"{name} changed after the chunk")
    log(f"analytics: snapshot v{pinned.version} pinned before the chunk is "
        f"byte-identical after it")
    t0 = time.monotonic()
    bc_err = max(bc_err, check_close(
        "betweenness after events", torch.from_numpy(maint.scores()).to(dev),
        bfs_betweenness(svc.graph, *pairs), 1e-9, 1e-9))
    log(f"oracle[betweenness after events]: equal to the BFS pair "
        f"dependencies (max |diff| so far {bc_err:.3g}; "
        f"{time.monotonic() - t0:.3f} s)")

    tri, quad = edge_list_cycles(svc.graph, hot)
    want_cyc = (CycleCount(3, tri, True, 4, tri, quad) if tri else
                CycleCount(4, quad, True, 4, 0, quad) if quad else
                CycleCount(INF, 0, False, 4, 0, 0))
    if cyc != want_cyc:
        raise AssertionError(f"cycles through {hot}: {cyc} != edge list "
                             f"{want_cyc}")
    degree = int((live_edges(svc.graph)[0] == hot).sum())
    log(f"analytics: cycles through vertex {hot} (degree {degree}) in "
        f"{step_s['cycles']:.3f} s: {cyc}, equal to the edge list's counts")

    want_recs = edge_list_recommend(svc.graph, u, ana.top_k)
    if [(r.vertex, r.score) for r in recs] != want_recs or \
            any(r.dist != 2 for r in recs) or not recs:
        raise AssertionError(f"recommend({u}): {recs} != edge list "
                             f"{want_recs}")
    log(f"analytics: recommend({u}) in {step_s['recommend']:.3f} s: "
        f"{len(recs)} candidates, equal to the edge list's common-friend "
        f"counts: {[(r.vertex, r.score) for r in recs]}")

    pna_cpu = PNA(cfg, device="cpu")
    pna_cpu.load_state_dict({k: x.cpu() for k, x in pna.state_dict().items()})
    _, model_cpu, _ = rerank(view, u, recs, pna_cpu, table)
    rerank_err = check_close("re-rank, card vs CPU", torch.from_numpy(model),
                             torch.from_numpy(model_cpu), 1e-4, 1e-5)
    order = np.argsort(-model, kind="stable")
    log(f"analytics: PNA ({cfg.n_layers} layers, d_hidden {cfg.d_hidden}) "
        f"over the {sub_n}-node ego net + embedding_bag mean pooling in "
        f"{step_s['rerank']:.3f} s; re-rank "
        f"{[(int(cand[i]), round(float(model[i]), 4)) for i in order]}; "
        f"equal to the CPU forward (max |diff| {rerank_err:.3g})")

    log(f"launches on the main paths: {json.dumps(counts.by_path)}")
    counts.check()

    # -- 3b. kernels vs plain at the main paths' shapes, and their times -----
    s, t = batches[0]
    rows = prep_rows(svc.index, torch.from_numpy(s).to(dev),
                     torch.from_numpy(t).to(dev))
    rows = tuple(r.contiguous() for r in rows)
    got = K.spc_query_cuda(*rows)
    torch.cuda.synchronize()
    max_err = max(max_err, check_equal("main-path rows", got,
                                       spc_query_ref(*rows)))
    b, l_cap = rows[0].shape
    got = merge_rows(*rows)
    torch.cuda.synchronize()
    check_equal("main-path rows, plain merge", got, spc_query_ref(*rows))
    ms = cuda_ms(lambda: K.spc_query_cuda(*rows), reps=200)
    # plain_ms: the L x L table the kernel is held against (the
    # correctness reference); plain_merge_ms: the port's plain-torch
    # sorted merge, the same function at the same shape
    plain_ms = cuda_ms(lambda: spc_query_ref(*rows), reps=5, warmup=1)
    merge_ms = cuda_ms(lambda: merge_rows(*rows), reps=50)
    nbytes, ops, common_hubs = spc_query_work(rows)
    bound, by = bound_ms(nbytes, ops)
    log(f"spc_query at (B={b}, L={l_cap}): {ms:.5f} ms, plain table "
        f"{plain_ms:.4f} ms, plain merge {merge_ms:.5f} ms, bound "
        f"{bound:.5f} ms ({nbytes} B, {ops} ops, {common_hubs} common "
        f"hubs) on {card}")

    bags = torch.from_numpy(common_friend_bags(view, u, cand)).to(dev)
    tz = torch.cat([table, torch.zeros_like(table[:1])]).to(dev)
    got = EB.embedding_bag_cuda(bags, tz)
    torch.cuda.synchronize()
    bag_err = max(bag_err, check_close("embedding_bag main-path bags", got,
                                       embedding_bag_ref(bags, tz),
                                       1e-6, 1e-6))
    bag_ms = cuda_ms(lambda: EB.embedding_bag_cuda(bags, tz), 200)
    bag_plain_ms = cuda_ms(lambda: embedding_bag_ref(bags, tz), 200)
    bag_lib_ms = cuda_ms(lambda: F.embedding_bag(bags, tz, mode="sum"), 200)
    bag_bytes, bag_ops, _ = embedding_bag_work(bags, tz)
    bag_bound, bag_by = bound_ms(bag_bytes, bag_ops)
    log(f"embedding_bag at the re-rank's bags {tuple(bags.shape)}, table "
        f"{tuple(tz.shape)}: {bag_ms:.5f} ms, plain {bag_plain_ms:.5f} ms, "
        f"F.embedding_bag {bag_lib_ms:.5f} ms, bound {bag_bound:.7f} ms "
        f"({bag_bytes} B) on {card}")

    kernels = [{
        "name": "spc_query", "route": "cuda",
        "source": KERNEL_SOURCES["spc_query"][0],
        "replaces": KERNEL_SOURCES["spc_query"][1],
        "launches": counts.of("spc_query")[0],
        "launches_by_path": counts.of("spc_query")[1], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "plain_merge_ms": merge_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }, {
        "name": "embedding_bag", "route": "cuda",
        "source": KERNEL_SOURCES["embedding_bag"][0],
        "replaces": KERNEL_SOURCES["embedding_bag"][1],
        "launches": counts.of("embedding_bag")[0],
        "launches_by_path": counts.of("embedding_bag")[1],
        "max_abs_err": bag_err,
        "ms": bag_ms, "plain_ms": bag_plain_ms, "bound_ms": bag_bound,
        "bound_by": bag_by, "library_ms": bag_lib_ms,
        "shape": list(bags.shape), "shapes": bag_shapes,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
