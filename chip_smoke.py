#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--halvings K] [--seed S]

Phases, each reported on its own line(s):

1. device    -- the card's name and power limit (``nvidia-smi``).
2. build     -- compiles every CUDA kernel of the main path from the
                sources under ``src/repro_torch/csrc`` (one ``nvcc`` per
                source, started together) and prints the build seconds.
3. kernels   -- holds each kernel against its plain PyTorch version on
                the card, exactly (integer outputs): the TPU sweep
                shapes, hand-made rows with counts 2^24 + 1 and above
                2^32, and a batch of 1024 pairs gathered from the built
                index (run after phase 4).
4. build     -- ``DynamicSPC(..., device="cuda", construct_batch=32,
                l_cap=None)`` on a power-law graph at the ``dspc``
                configuration's scale (n = 65536, m = 524288, weights
                proportional to i^-0.8), halved ``--halvings`` times.
5. maintain  -- one ``apply_events`` chunk of ``update_batch`` = 64
                events (32 inserts, 32 deletes from ``graph_stream``).
6. serve     -- 64 batches of 1024 random pairs through
                ``QueryEngine(route="auto")`` (the kernel route on the
                card), then the same batches on the plain-torch merge
                route; both must agree.
7. oracle    -- for 8 sampled sources, ``plain_spc_bfs`` on the current
                graph equals the engine's (dist, count) for every
                target; checked after phase 4 and after phase 5.

The launch counters are set to 0 just before phase 4 and read right
after phase 6; every kernel of the path must have launched.  The line
before the last is a JSON object with one entry per kernel (its time on
the card, its plain version's time, its bound, its launches); the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Without a CUDA device, or without the repository's sources
beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
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
}


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
    from repro_torch.configs.dspc import CONFIG
    from repro_torch.core import bfs as B
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.core.query import merge_rows
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.kernels import common
    from repro_torch.kernels.spc_query import kernel as K
    from repro_torch.kernels.spc_query.ops import prep_rows
    from repro_torch.kernels.spc_query.ref import spc_query_ref
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

    # -- 3a. kernel vs plain on synthetic rows ---------------------------
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

    # -- 4. main path: build ------------------------------------------------
    n, m = CONFIG.n >> args.halvings, CONFIG.m >> args.halvings
    reduced = ([f"n {CONFIG.n}->{n}", f"m {CONFIG.m}->{m}"]
               if args.halvings else [])
    t0 = time.monotonic()
    edges = power_law_edges(n, m, args.seed)
    log(f"graph: n={n} m={len(edges)} power-law w~i^-0.8 "
        f"({time.monotonic() - t0:.2f} s on the host)")
    log(f"reduced: {json.dumps(reduced)}")
    K.launches.count = 0
    B.frontier_syncs.count = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
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

    # -- 5. maintain --------------------------------------------------------
    half = CONFIG.update_batch // 2
    events = graph_stream(edges, n, half, half, seed=args.seed)
    syncs0 = B.frontier_syncs.count
    regrows0 = svc.stats.label_regrows
    torch.cuda.synchronize()
    t0 = time.monotonic()
    svc.apply_events(events, batch_size=CONFIG.update_batch)
    torch.cuda.synchronize()
    st = svc.stats.snapshot()
    log(f"maintain: {len(events)} events in {st.batches} chunk(s), "
        f"{time.monotonic() - t0:.3f} s, inserts {st.inserts}, deletions "
        f"{st.deletions}, label regrows {st.label_regrows - regrows0}, edge "
        f"regrows {st.edge_regrows}, host syncs {B.frontier_syncs.count - syncs0}, "
        f"l_cap {svc.index.l_cap}")
    oracle(svc, engine, sources, "after events")

    # -- 6. serve -----------------------------------------------------------
    batches = [(rng.integers(0, n, 1024), rng.integers(0, n, 1024))
               for _ in range(64)]
    served = {}
    for route in ("auto", "merge"):
        eng = QueryEngine(route=route)
        eng.query_batch(svc.index, *batches[0])      # warm-up
        torch.cuda.synchronize()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(65)]
        outs = []
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
    launches = {"spc_query": K.launches.count}
    log(f"launches on the main path: {launches}")
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    # -- 3b. kernel vs plain at the main path's shape, and its times ----------
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
    nbytes, ops, common = spc_query_work(rows)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, \
        1e3 * ops / SCALAR_OPS_PER_S
    log(f"spc_query at (B={b}, L={l_cap}): {ms:.5f} ms, plain table "
        f"{plain_ms:.4f} ms, plain merge {merge_ms:.5f} ms, bound "
        f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B, {ops} ops, {common} "
        f"common hubs) on {card}")
    kernels = [{
        "name": "spc_query", "route": "cuda",
        "source": KERNEL_SOURCES["spc_query"][0],
        "replaces": KERNEL_SOURCES["spc_query"][1],
        "launches": launches["spc_query"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "plain_merge_ms": merge_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
