#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--halvings K] [--seed S] [--lm-seeds S1,S2,...]

Phases, each reported on its own line(s):

1. device    -- the card's name and power limit (``nvidia-smi``).
2. build     -- compiles every CUDA kernel from the sources under
                ``src/repro_torch/csrc`` (one ``nvcc`` per source,
                started together) and prints the build seconds.
3. kernels   -- holds each kernel against its plain PyTorch version on
                the card.  spc_query exactly (integer outputs): the TPU
                sweep shapes, hand-made rows with counts 2^24 + 1 and
                above 2^32, rows whose hubs repeat (the reference
                microbench's draw and a hand-made pair), and 1024 pairs
                gathered from the built index.  segment_matmul in both
                its designs (sorted and blocked, whichever the plan
                picks) on the TPU sweep (ids up to n + 5, then shifted
                to negatives) within rtol = atol = 1e-6 in float32 and
                1e-2 in bfloat16 against the float32 sum of the same
                values, at E = 0, and on one segment of 14329 edges
                (integer values: exact); two launches bitwise equal.
                embedding_bag within rtol = atol = 1e-6 in float32 (only
                the fp32 summation order differs) and 1e-2 in bfloat16
                against the float32 sum of the same bfloat16 rows: the
                TPU sweep shapes, the
                recsys shapes of ``configs/dien.py`` (vocab 100000,
                D = 18, 8 ids per bag, 512 x 4 and 262144 x 4 bags) and
                the re-rank's own bags; ids that count from the end
                (F1) through the kernel and the ops, exactly.  The
                main-path shapes are checked and timed after phase A2.
4. build     -- ``DynamicSPC(..., device="cuda", construct_batch=32,
                l_cap=None)`` on a power-law graph at the ``dspc``
                configuration's scale (n = 65536, m = 524288, weights
                proportional to i^-0.8), halved ``--halvings`` times.
K.  kernels   -- the kernel microbench entry point
                (``repro_torch.bench.kernels_bench``): spc_query at
                b = 4096 pairs of l = 64 labels and segment_matmul at
                e = 16384, n = 2048, d = 128 (the reference's defaults),
                then ``gather_scatter`` of 128 node features over the
                built graph's edge slots (E = 2m, N = n, dst unsorted).
                Outside the path, in both designs: that aggregation
                equal to the plain version bit for bit in float32 and
                bfloat16 (features rounded to multiples of 2^-6, so every
                sum is exact); on N(0, 1) messages two launches bitwise
                equal and within the fp32 summation bound of the float64
                sum at the design's depth; the BFS relaxation form (D =
                1, n + 1 segments) equal to the int64 ``edge_relax``.
                Then at each shape (the microbench and the graph's three)
                both designs and ``index_add_`` timed in turn, SEG_REPS
                rounds, and the card's busy time per call of the planned
                design and of ``index_add_`` from a profiler trace.
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
L1. LM params -- ``init_params`` of qwen2-1.5b (``configs/qwen2_1_5b.py``
                CONFIG with ``tp = 1``: the published 12 query heads, no
                mesh padding) in bfloat16, drawn from a CUDA generator
                seeded with ``--seed``.
L2. prefill  -- 16 prompts of 32768 random token ids (the
                ``decode_32k`` context; its global batch 128 cut to 16
                to fit one card), ``s_max = 32768 + 64``, prefilled 4 at
                a time (blockwise attention), each group's cache copied
                into the batch cache.
L3. decode   -- 64 greedy ``decode_step``s; every layer's decode
                attention runs on the flash_decode kernel.  Step latency
                from CUDA events, tokens/s from the host clock.  The
                last 4 steps are then replayed under ``torch.profiler``:
                the card's busy time per step and its idle share of the
                step p50, and (replayed again) its top kernels by device
                ms per step.
L4. consistency -- as ``examples/serve_lm.py`` checks it: the first 2
                requests prefilled again with the 64 tokens fed to the
                decode steps (t = 32832, ragged against the 1024-key
                blocks); its last logits within a relative L2 error of
                1.87e-2 of the last decode step's (fp32), argmax agreement
                printed.  Controls: the fed tokens replayed from these
                requests' prompt cache on the port's route must pass the
                same limit, and two planted faults in place of decode
                attention must fail it: the reference's arithmetic
                (scores and probabilities rounded to bf16) and one span
                of the kernel at the main path's shape left out (the
                span comes from the kernel's own ``plan``).
flash_decode is held against its plain version (the KV heads expanded,
fp32 softmax) at the TPU sweep shapes and GQA groups in float32 (rtol =
atol = 2e-5, the TPU test's) and bfloat16 (1e-2 against the plain
version on the fp32 copies of the same inputs; both routes, the
planned one twice and bitwise equal) in phase 3.  At the main path's
shape (layer 0's cache after L3, after L4) it is held in bfloat16
within atol 1e-3 + rtol 1e-2 on the tensor-core route and on the
CUDA-core route (the output's RMS is about 0.009 there; the same check
must fail the plain version with its last span left out) and in
float32 on the same cache within 2e-5; then both routes and SDPA are
timed in turn, FD_REPS rounds; the planned route's kernels' device ms
per call come from the L3 trace.  The build prints each kernel
function's registers, shared memory and spills (``nvcc -Xptxas -v``)
and fails if a redesigned kernel (``flash_decode_mma``,
``block_sums``) spills.

``--lm-seeds 0,1,...`` builds the kernels and then only reads L4 and its
controls for the first 2 requests of each seed (prefilled and decoded
as 2 requests), prints them and exits.

Launches are counted for each main path on its own: the DSPC path
(phases 4, 5, 6), the kernels path (K), the analytics path (the timed
steps of A1 and A2) and the LM path (L2 and L3; flash_decode exactly
28 x 64 times).  The
launch counters are set to 0 just before each of these phases and read
just after it; the oracles, L4 and the kernel checks run outside them
and count nowhere.  Each path must have launched each of its kernels
(``PATH_KERNELS``).  The line before the last is a JSON object with one
entry per kernel (its time on the card, its plain version's time, its
bound, one library call's time where there is one, its launches on the
main paths, also by path); the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero.  Without a CUDA
device, or without the repository's sources beside it, the script exits
1 and prints no result.

Plain products run in full float32 where they are float32
(``allow_tf32`` off for matmuls and cuDNN), as XLA's on the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
    "segment_matmul": ("src/repro_torch/csrc/segment_matmul.cu",
                       "src/repro/kernels/segment_matmul/kernel.py:34"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:29"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:32"),
}

#: The kernels each main path must launch.
PATH_KERNELS = {"dspc": ("spc_query",), "kernels": ("spc_query",
                                                    "segment_matmul"),
                "analytics": ("embedding_bag",), "lm": ("flash_decode",)}

#: The segment_matmul sweep of tests/kernels/test_kernels.py (e, n, d),
#: inputs drawn as that test draws them (ids in [0, n + 5): some dropped).
SEG_SWEEP = ((100, 30, 16), (1000, 128, 64), (513, 65, 8), (64, 300, 4))
#: The longest segment of the dspc CONFIG graph (vertex degree 14329):
#: one segment of this many edges is checked on its own.
SEG_LONG = 14329
#: The width of the node features the kernels path aggregates.
SEG_FEATURES = 128
#: Rounds in which both segment_matmul designs and index_add_ are timed
#: in turn at each shape, and back-to-back calls traced for the card's
#: busy time per call.
SEG_REPS, SEG_TRACE_CALLS = 3, 20

#: The TPU sweep of tests/kernels/test_kernels.py (b, s, v, d), and the
#: recsys shapes of configs/dien.py: vocab 100000, D = 18, 8 ids per
#: bag, 4 bags per example at serve_p99 (512) and serve_bulk (262144).
BAG_SWEEP = ((4, 3, 16, 128), (32, 20, 1000, 16), (7, 1, 64, 32))
BAG_RECSYS = (("serve_p99", 512 * 4), ("serve_bulk", 262144 * 4))
RECSYS_VOCAB, RECSYS_DIM, RECSYS_BAG = 100_000, 18, 8

#: flash_decode checks (b, h, kvh, s, d): the TPU sweep of
#: tests/kernels/test_kernels.py as b = BH rows of one head each, then
#: GQA groups of 4, 6 (qwen2-1.5b at tp = 1) and 12 (two head chunks).
DECODE_SWEEP = ((4, 1, 1, 64, 32), (8, 1, 1, 1024, 128), (3, 1, 1, 100, 64),
                (16, 1, 1, 333, 16), (2, 8, 2, 64, 32),
                (3, 12, 2, 2000, 128), (2, 12, 1, 700, 64))
#: The LM path: decode_32k's context, the requests decoded together
#: (its global batch of 128 cut to fit one card) and prefilled together,
#: decode steps, the requests L4 prefills again, and its limit on the
#: relative L2 logit error: midway between the port's largest reading
#: (0.01744) and the bf16-score fault's smallest (0.02003) on an H100
#: over seeds 0-3 (``--lm-seeds``) and the main run.
LM_PROMPT, LM_BATCH, LM_GROUP, LM_STEPS = 32768, 16, 4, 64
LM_CHECK, LM_REL_TOL = 2, 1.87e-2
#: Decode steps replayed under the profiler for the device-busy time,
#: and the kernels of a step reported by device time.
LM_TRACE_STEPS, LM_TOP_KERNELS = 4, 8
#: flash_decode at the main path's shape in bfloat16: |got - want| <=
#: MAIN_ATOL + MAIN_RTOL |want| (the output's RMS is about 0.009 there).
MAIN_RTOL, MAIN_ATOL = 1e-2, 1e-3
#: Rounds in which flash_decode's two routes and SDPA are timed in turn at
#: the main path's shape.
FD_REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_usage(log: str) -> list:
    """Each kernel function's registers, spills and static shared memory
    as ``nvcc -Xptxas -v`` printed them in ``log``: a list of
    ``{"function", "registers", "spill_stores", "spill_loads",
    "smem"}``, the function's name read out of its mangled name with its
    template arguments (``flash_decode_mma<128>``)."""
    import re
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        mangled, info = part.split("'", 1)
        info = info.split("Compile time", 1)[0]
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)([A-Za-z_]\w*)", mangled)
        name, args = mangled, ""
        if m:
            name = m.group(2)[:int(m.group(1))]
            args = m.group(2)[int(m.group(1)):]
        if args.startswith("I"):
            targs = re.findall(r"Li(\d+)E|13__nv_(bfloat16)|(?<=[IE])f",
                               args.split("EEv", 1)[0])
            name += "<" + ", ".join(i or ("bf16" if t else "float")
                                    for i, t in targs) + ">"

        def num(pattern):
            found = re.search(pattern, info)
            return int(found.group(1)) if found else 0
        out.append({"function": name,
                    "registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "smem": num(r"(\d+) bytes smem")})
    return out


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


def repeated_hub_rows(device):
    """One hand-made pair whose hubs repeat on both sides at two
    distances (rows sorted by hub only), and its (dist, count) worked
    out by hand over the L x L table.  Hub 2: s at (dist 2, cnt 5) and
    (1, 2), t at (3, 3) and (1, 4): sums 5, 3, 4 and 2 (2 x 4 = 8).  Hub
    7: s at (0, 1) and (3, 7), t at (INF, 6), (4, 2) and (2, 5): sums
    4, 2 (1 x 5 = 5), 7 and 5.  So (2, 8 + 5).  Taking only the first t
    entry of each hub gives (4, 6); stopping a run at its INF entry
    gives (2, 8)."""
    import torch
    INF = 1 << 28
    n = 10
    hub_s, dist_s, cnt_s = [2, 2, 5, 7, 7, n], [2, 1, 0, 0, 3, INF], \
        [5, 2, 3, 1, 7, 0]
    hub_t, dist_t, cnt_t = [2, 2, 4, 7, 7, 7], [3, 1, 0, INF, 4, 2], \
        [3, 4, 9, 6, 2, 5]
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dts = (torch.int32, torch.int32, torch.int64) * 2
    return (tuple(torch.tensor([r], dtype=dt, device=device)
                  for r, dt in zip(rows, dts)), ([2], [13]))


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


def wrapped_id_rows(device):
    """F1's smallest input: a table of V = 4 rows [1, 2] .. [7, 8] plus
    the zero row, and ids that count from the end (-3 reads row 2, -5 row
    0, -1 the zero row), one past the table (4) and below -(V + 1) (-6,
    -10^6: the zero row in the port, F2).  Returns (ids int32 [6, 1],
    table float32 [5, 2], the rows the bags must give)."""
    import torch
    table = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8], [0, 0]],
                         dtype=torch.float32, device=device)
    ids = torch.tensor([[-3], [-1], [-5], [4], [-6], [-10 ** 6]],
                       dtype=torch.int32, device=device)
    return ids, table, [[5, 6], [0, 0], [1, 2], [0, 0], [0, 0], [0, 0]]


def embedding_bag_work(ids, table):
    """(bytes, operations, distinct rows) that the embedding_bag function
    needs on these inputs.  Bytes: the ids, each distinct table row the
    bags touch once, and the output.  Operations: one add per id and
    column."""
    import torch
    b, s = ids.shape
    v1, d = table.shape
    wrapped = torch.where(ids < 0, ids + v1, ids)        # from the end
    rows = torch.where((wrapped >= 0) & (wrapped < v1 - 1), wrapped, v1 - 1)
    distinct = int(torch.unique(rows).numel())
    elem = table.element_size()
    nbytes = ids.numel() * ids.element_size() + (distinct + b) * d * elem
    return nbytes, b * s * d, distinct


def segment_sweep_inputs(e: int, n: int, d: int, device):
    """float32 vals [e, d] ~ N(0, 1) and int32 dst [e] over [0, n + 5)
    (ids from n on are dropped), drawn as TestSegmentMatmul draws them."""
    import torch
    r = np.random.default_rng(e + n)
    vals = torch.from_numpy(r.standard_normal((e, d)).astype(np.float32))
    dst = torch.from_numpy(r.integers(0, n + 5, e).astype(np.int32))
    return vals.to(device), dst.to(device)


def sequential_plain(vals, dst, n: int):
    """segment_matmul's plain version on the CPU copy of the inputs,
    moved back: there ``index_add_`` adds in index order, the same float32
    sums on every run, where on the card its atomics add in an order that
    changes from run to run."""
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    return segment_matmul_ref(vals.cpu(), dst.cpu(), n).to(vals.device)


def quantized_features(n: int, d: int, rng, device):
    """float32 [n, d]: N(0, 1) rounded to multiples of 2^-6 and clipped
    to [-4, 4].  Every partial sum of fewer than 2^16 such values is a
    multiple of 2^-6 below 2^18, exact in float32 in any order, and the
    values stay multiples of 2^-6 in bfloat16; so a kernel that sums them
    must equal its plain version bit for bit."""
    import torch
    x = np.clip(np.round(rng.standard_normal((n, d)) * 64) / 64, -4, 4)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def segment_matmul_work(vals, dst, n: int):
    """(bytes, operations, longest segment) that the segment_matmul
    function needs on these inputs.  Bytes: each kept row of vals once,
    dst once and the output once.  Operations: one add per kept edge and
    column."""
    import torch
    keep = (dst >= 0) & (dst < n)
    kept = int(keep.sum())
    d, elem = vals.shape[1], vals.element_size()
    nbytes = kept * d * elem + dst.numel() * dst.element_size() + n * d * elem
    longest = int(torch.bincount(dst[keep].long()).max()) if kept else 0
    return nbytes, kept * d, longest


def check_summation_bound(tag, got, vals, dst, n: int, design: str):
    """Float32 segment sums ``got`` against the float64 sums of the same
    values, within the forward error bound of float32 summation at the
    depth of the segment_matmul ``design`` that summed them (the most
    adds a term passes through, ``summation_depth``): |got - sum| <=
    depth x 2^-24 x sum |x| per entry.  Returns the largest
    |got - sum|."""
    import torch
    from repro_torch.kernels.segment_matmul.kernel import summation_depth
    keep = (dst >= 0) & (dst < n)
    ids, x = dst[keep].long(), vals[keep].double()
    d = vals.shape[1]
    truth = torch.zeros((n, d), dtype=torch.float64,
                        device=vals.device).index_add_(0, ids, x)
    abs_sum = torch.zeros_like(truth).index_add_(0, ids, x.abs())
    longest = int(torch.bincount(ids).max()) if ids.numel() else 0
    depth = summation_depth(design, longest)
    diff = (got.double() - truth).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= depth * 2.0 ** -24 * abs_sum).all()):
        raise AssertionError(f"{tag}: max |diff| {err} from the float64 "
                             f"sum, beyond {depth} x 2^-24 x sum |x|")
    return err


def decode_inputs(b, h, kvh, s, d, rng, device):
    """float32 q [b, h, d], k and v [b, s, kvh, d] N(0, 1) and int32
    lengths uniform over [1, s], with the last row's length 0 when
    b > 2 (it must give zeros)."""
    import torch
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    if b > 2:
        lengths[-1] = 0
    return tuple(x.to(device) for x in (q, k, v, torch.from_numpy(lengths)))


def flash_decode_work(q, k, lengths):
    """(bytes, operations) that the flash_decode function needs on these
    inputs.  Bytes: the K and V rows of each KV head within its row's
    length, each read once however many query heads share it, plus q,
    the output and the lengths.  Operations: 4 D per query head and
    valid position (a multiply and an add for q . k and for p . v)."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    valid = int(lengths.clamp(0, s).sum())
    nbytes = (2 * valid * kvh * d * k.element_size()
              + 2 * q.numel() * q.element_size()
              + lengths.numel() * lengths.element_size())
    return nbytes, 4 * valid * h * d


def prefill_in_groups(params, cfg, prompts, s_max: int, group: int):
    """``prefill`` the requests ``group`` at a time and copy each group's
    cache into one batch cache.  Returns (logits [B, Vpad], cache)."""
    import torch
    from repro_torch.models import transformer as tf
    b = prompts.shape[0]
    cache = tf.init_cache(cfg, b, s_max, device=prompts.device)
    logits = []
    for lo in range(0, b, group):
        lg, part = tf.prefill(params, prompts[lo:lo + group], cfg, s_max)
        cache["k"][:, lo:lo + group] = part["k"]
        cache["v"][:, lo:lo + group] = part["v"]
        cache["lengths"][lo:lo + group] = part["lengths"]
        logits.append(lg)
        del part
    return torch.cat(logits), cache


def greedy_decode(params, cfg, cache, token, steps: int):
    """``steps`` greedy ``decode_step``s, feeding ``token`` int32 [B]
    first.  Returns (the fed tokens [B, steps], the last step's logits,
    the cache, each step's device ms from CUDA events -- empty off the
    card)."""
    import torch
    from repro_torch.models import transformer as tf
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
              if token.is_cuda else [])
    fed = []
    if events:
        events[0].record()
    for i in range(steps):
        fed.append(token)
        logits, cache = tf.decode_step(params, cache, token, cfg)
        token = logits.argmax(dim=-1).to(torch.int32)
        if events:
            events[i + 1].record()
    if events:
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return torch.stack(fed, dim=1), logits, cache, ms


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def decode_consistency(params, cfg, prompts, fed, last_logits, s_max: int):
    """Prefill the prompts followed by the fed tokens and compare its
    last logits with the last decode step's: (relative L2 error in
    float32, rows whose argmax agrees, the prefill's logits)."""
    import torch
    from repro_torch.models import transformer as tf
    full = torch.cat([prompts, fed.to(prompts.dtype)], dim=1)
    want, _ = tf.prefill(params, full, cfg, s_max)
    agree = int((last_logits.argmax(-1) == want.argmax(-1)).sum())
    return rel_l2(last_logits, want), agree, want


def bf16_score_attention(q, k, v, lengths):
    """A planted fault for L4: decode attention as the reference's
    ``gqa_decode`` computes it, with the scores and the probabilities
    rounded to the cache's dtype around a float32 softmax."""
    import torch
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.to(k.dtype).reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) / float(np.sqrt(d))
    valid = torch.arange(s, device=k.device) < lengths[:, None]
    scores = scores.float().masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(k.dtype)
    ctx = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return ctx.reshape(b, h, d).to(q.dtype)


def drop_span_attention(span: int):
    """A planted fault for L4: decode attention that leaves out the
    cache's first ``span`` positions, as a kernel that lost one span."""
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref

    def attend(q, k, v, lengths):
        return decode_attention_ref(q, k[:, span:], v[:, span:],
                                    (lengths - span).clamp(min=0))
    return attend


def replay_decode(params, cfg, cache, fed, start: int, attention=None):
    """Feed ``fed`` [B, steps] through ``decode_step`` from ``cache``
    taken back to length ``start`` (its later positions are written
    again), with ``attention`` in place of ``decode_attention`` if
    given.  Returns the last step's logits."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as tf
    cache = dict(cache, lengths=torch.full_like(cache["lengths"], start))
    saved = A.decode_attention
    A.decode_attention = attention or saved
    try:
        for i in range(fed.shape[1]):
            logits, cache = tf.decode_step(params, cache, fed[:, i], cfg)
    finally:
        A.decode_attention = saved
    return logits


def lm_fault_span(cfg, sms: int) -> int:
    """The span of S that one flash_decode CTA covers when the LM path's
    LM_BATCH requests decode on a card of ``sms`` SMs (the kernel's own
    ``plan``): the planted faults leave out one."""
    from repro_torch.kernels.flash_decode.kernel import plan
    return plan(LM_BATCH, cfg.n_kv_heads, cfg.padded_heads,
                LM_PROMPT + LM_STEPS, cfg.d_head, cfg.act_dtype,
                sms).split_len


def lm_consistency(params, cfg, prompts, fed, last_logits, cache,
                   s_max: int, span: int) -> dict:
    """L4 and its controls for the requests of ``prompts``: the decode's
    last logits against a prefill of prompt + fed tokens (``decode``,
    ``argmax``), then the fed tokens again from these requests' ``cache``
    on the port's route (``replay``) and with two planted faults in
    place of decode attention (``bf16_scores``, ``drop_span``: the
    first ``span`` positions left out), each as a relative L2 error
    against the same prefill."""
    rel, agree, want = decode_consistency(params, cfg, prompts, fed,
                                          last_logits, s_max)
    t = prompts.shape[1]
    out = {"decode": rel, "argmax": agree,
           "replay": rel_l2(replay_decode(params, cfg, cache, fed, t), want)}
    for name, attend in (("bf16_scores", bf16_score_attention),
                         ("drop_span", drop_span_attention(span))):
        out[name] = rel_l2(replay_decode(params, cfg, cache, fed, t, attend),
                           want)
    return out


def check_l4(l4: dict) -> None:
    """L4's limit must pass the port's decode, and its replay from the
    prompts' cache, and fail both planted faults."""
    for key in ("decode", "replay"):
        if not l4[key] <= LM_REL_TOL:
            raise AssertionError(f"L4: {key} logits differ from a prefill "
                                 f"of the same tokens by {l4[key]:.4g} "
                                 f"(relative L2), beyond {LM_REL_TOL}")
    for key in ("bf16_scores", "drop_span"):
        if not l4[key] > LM_REL_TOL:
            raise AssertionError(f"L4: the limit {LM_REL_TOL} passes the "
                                 f"planted fault {key} ({l4[key]:.4g})")


def lm_prompts(cfg, seed: int, device):
    """The LM path's LM_BATCH prompts of LM_PROMPT token ids from
    ``seed``."""
    import torch
    ids = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def lm_seed_readings(seeds, card: str) -> int:
    """``--lm-seeds``: L4 and its controls for the first LM_CHECK
    requests of each seed, with the parameters and prompts the main run
    draws from that seed (prefilled and decoded as LM_CHECK requests).
    Prints one line per seed and a JSON object of all; checks nothing."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN_CONFIG
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(QWEN_CONFIG, tp=1)
    s_max = LM_PROMPT + LM_STEPS
    span = lm_fault_span(cfg, torch.cuda.get_device_properties(
        0).multi_processor_count)
    readings = {}
    for seed in seeds:
        t0 = time.monotonic()
        params = tf.init_params(
            cfg, generator=torch.Generator("cuda").manual_seed(seed))
        prompts = lm_prompts(cfg, seed, "cuda")[:LM_CHECK]
        logits, cache = tf.prefill(params, prompts, cfg, s_max)
        fed, last, cache, _ = greedy_decode(
            params, cfg, cache, logits.argmax(dim=-1).to(torch.int32),
            LM_STEPS)
        readings[seed] = lm_consistency(params, cfg, prompts, fed, last,
                                        cache, s_max, span)
        log(f"L4 seed {seed}: {json.dumps(readings[seed])} "
            f"({time.monotonic() - t0:.3f} s on {card})")
        del params, logits, cache, fed, last
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"l4_seeds": readings, "limit": LM_REL_TOL,
                      "drop_span": span, "card": card}), flush=True)
    return 0


def device_busy_ms(fn):
    """(ms the card was busy, ms from its first device event's start to
    its last's end) while ``fn()`` ran: the union of the device events'
    intervals in a ``torch.profiler`` trace.  (None, None) when the trace
    holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, None
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    return busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3


def kernel_name(raw: str) -> str:
    """A kernel's name as a trace shows it, without its return type,
    anonymous namespaces and parameters: ``flash_decode_mma<128>``."""
    name = raw.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def device_ms_by_kernel(fn, per: int) -> dict:
    """Device milliseconds of each kernel that ``fn()`` launched, by
    kernel name (``kernel_name``), divided by ``per`` (the steps ``fn``
    makes), from a ``torch.profiler`` trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.name)
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / per
    return out


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
    ap.add_argument("--lm-seeds", default="",
                    help="comma-separated seeds: build the kernels, then "
                         "only read L4 and its controls for the first "
                         f"{LM_CHECK} requests of each seed and exit")
    args = ap.parse_args(argv)
    start = time.monotonic()

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
    import gc
    import torch.nn.functional as F
    from repro_torch.analytics import AnalyticsEngine, CycleCount
    from repro_torch.bench import kernels_bench as KB
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.dspc import CONFIG
    from repro_torch.configs.pna import CONFIG as PNA_CONFIG
    from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN_CONFIG
    from repro_torch.core import bfs as B
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.core.graph import INF
    from repro_torch.core.query import merge_rows
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_decode import kernel as FD
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.segment_matmul import kernel as SM
    from repro_torch.kernels.segment_matmul.ops import gather_scatter
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    from repro_torch.kernels.spc_query import kernel as K
    from repro_torch.kernels.spc_query.ops import prep_rows
    from repro_torch.kernels.spc_query.ref import spc_query_ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.gnn.pna import PNA
    from repro_torch.serve.engine import QueryEngine

    # plain float32 products in full float32, as XLA's on the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    usage = {name: ptxas_usage(text)
             for name, text in common.build_logs.items()}
    for name, funcs in usage.items():
        log(f"ptxas[{name}]: " + "; ".join(
            f"{f['function']} {f['registers']} registers, smem {f['smem']} "
            f"B, spills {f['spill_stores']}/{f['spill_loads']} B"
            for f in funcs))
    spilled = [f["function"] for f in usage.get("flash_decode", [])
               + usage.get("segment_matmul", [])
               if f["function"].startswith(("flash_decode_mma", "block_sums"))
               and f["spill_stores"] + f["spill_loads"]]
    if spilled:
        raise AssertionError(f"the redesigned kernels spill: {spilled}")
    if args.lm_seeds:
        return lm_seed_readings([int(x) for x in args.lm_seeds.split(",")],
                                card)

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
    # hubs that repeat within a row: the reference microbench's own draw,
    # and a hand-made pair
    rows = tuple(torch.from_numpy(x).to(dev) for x in KB.query_inputs())
    got = K.spc_query_cuda(*rows)
    torch.cuda.synchronize()
    max_err = max(max_err, check_equal("microbench rows (repeated hubs)",
                                       got, spc_query_ref(*rows)))
    rows, want = repeated_hub_rows(dev)
    got = K.spc_query_cuda(*rows)
    torch.cuda.synchronize()
    max_err = max(max_err, check_equal("repeated hubs", got,
                                       spc_query_ref(*rows)))
    if [got[0].tolist(), got[1].tolist()] != list(want):
        raise AssertionError(f"repeated hubs: {got} != {want}")
    log(f"kernels: spc_query == plain on rows with repeated hubs (the "
        f"microbench draw, {tuple(rows[0].shape)} hand-made: {want}) (exact)")

    # both designs on every input, whichever the plan picks
    seg_designs = {"sorted": SM._sorted_cuda, "blocked": SM._blocked_cuda}
    seg_err, seg_err16 = 0.0, 0.0
    for e, n_seg, d in SEG_SWEEP:
        vals, dst = segment_sweep_inputs(e, n_seg, d, dev)
        for (tag, ids), (design, run) in itertools.product(
                (("", dst), (" negative ids", dst - 5)), seg_designs.items()):
            tag = f"segment_matmul {(e, n_seg, d)}{tag} {design}"
            got = run(vals, ids, n_seg)
            again = run(vals, ids, n_seg)
            torch.cuda.synchronize()
            seg_err = max(seg_err, check_close(
                f"{tag} f32", got, sequential_plain(vals, ids, n_seg),
                1e-6, 1e-6))
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two launches differ")
            vals16 = vals.to(torch.bfloat16)
            got16 = run(vals16, ids, n_seg)
            torch.cuda.synchronize()
            if got16.dtype != torch.bfloat16:
                raise AssertionError(f"segment_matmul bf16 gave {got16.dtype}")
            seg_err16 = max(seg_err16, check_close(
                f"{tag} bf16", got16.float(),
                segment_matmul_ref(vals16.float(), ids, n_seg), 1e-2, 1e-2))
    for design, run in seg_designs.items():
        empty = run(vals[:0], dst[:0], 7)
        torch.cuda.synchronize()
        if empty.shape != (7, vals.shape[1]) or empty.any():
            raise AssertionError(f"segment_matmul {design} with E = 0: "
                                 f"{empty}")
    # one segment of SEG_LONG edges among others, ids shuffled; integer
    # values, so every order of summation gives the same floats
    seg_rng = np.random.default_rng(args.seed + 4)
    long_ids = np.concatenate([np.full(SEG_LONG, 7),
                               seg_rng.integers(-3, 40, 3000)])
    long_dst = torch.from_numpy(seg_rng.permutation(long_ids)
                                .astype(np.int32))
    long_vals = torch.from_numpy(seg_rng.integers(
        -8, 9, (long_ids.size, 64)).astype(np.float32))
    long_dst, long_vals = long_dst.to(dev), long_vals.to(dev)
    for (design, run), x in itertools.product(
            seg_designs.items(), (long_vals, long_vals.to(torch.bfloat16))):
        got = run(x, long_dst, 32)
        again = run(x, long_dst, 32)
        torch.cuda.synchronize()
        if not (torch.equal(got, segment_matmul_ref(x, long_dst, 32))
                and torch.equal(got, again)):
            raise AssertionError(f"segment_matmul {design}: a segment of "
                                 f"{SEG_LONG} edges ({x.dtype}) differs "
                                 f"from plain")
    log(f"kernels: segment_matmul == plain in both designs on the TPU "
        f"sweep, with negative ids, unsorted, at E = 0 and with a segment of "
        f"{SEG_LONG} edges (f32 max |diff| {seg_err:.3g}, bf16 "
        f"{seg_err16:.3g} against the f32 sum; the long segment exact); two "
        f"launches bitwise equal")

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
    # F1: ids in [-(V + 1), -1] read from the end, as the reference reads
    # them; below that the zero row (F2)
    ids, table, want = wrapped_id_rows(dev)
    for tag, got in (("kernel", EB.embedding_bag_cuda(ids, table)),
                     ("ops", embedding_bag(ids, table[:-1]))):
        torch.cuda.synchronize()
        if got.tolist() != want or not torch.equal(
                got, embedding_bag_ref(ids, table)):
            raise AssertionError(f"embedding_bag {tag} on ids "
                                 f"{ids[:, 0].tolist()}: {got.tolist()} != "
                                 f"{want}")
    log(f"kernels: embedding_bag (kernel and ops) reads ids "
        f"{ids[:, 0].tolist()} of a 4-row table as rows {want} (exact)")

    dec_rng = np.random.default_rng(args.seed + 3)
    dec_err = dec_err16 = 0.0
    for b, h, kvh, s_len, d in DECODE_SWEEP:
        tag = f"flash_decode {(b, h, kvh, s_len, d)}"
        q, k, v, lengths = decode_inputs(b, h, kvh, s_len, d, dec_rng, dev)
        got = FD.flash_decode_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        dec_err = max(dec_err, check_close(
            f"{tag} f32", got, decode_attention_ref(q, k, v, lengths), 2e-5,
            2e-5))
        if b > 2 and got[-1].any():
            raise AssertionError(f"{tag}: the row of length 0 is not zero")
        q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
        want16 = decode_attention_ref(q16.float(), k16.float(), v16.float(),
                                      lengths)
        # the planned route (the tensor cores at D 64 and 128), twice, and
        # the CUDA-core route
        got16 = FD.flash_decode_cuda(q16, k16, v16, lengths)
        again = FD.flash_decode_cuda(q16, k16, v16, lengths)
        simt16 = FD._simt_cuda(q16, k16, v16, lengths)
        torch.cuda.synchronize()
        if not torch.equal(got16, again):
            raise AssertionError(f"{tag} bf16: two launches differ")
        for route, out in (("planned", got16), ("simt", simt16)):
            dec_err16 = max(dec_err16, check_close(
                f"{tag} bf16 {route}", out, want16, 1e-2, 1e-2))
            if b > 2 and out[-1].any():
                raise AssertionError(f"{tag} bf16 {route}: the row of "
                                     f"length 0 is not zero")
    log(f"kernels: flash_decode == plain on the TPU sweep and GQA groups "
        f"(f32 max |diff| {dec_err:.3g}, bf16 {dec_err16:.3g} on both "
        f"routes; rows of length 0 give zeros; two launches bitwise equal) "
        f"on {card}")

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
                           "segment_matmul": SM.launches,
                           "embedding_bag": EB.launches,
                           "flash_decode": FD.launches})
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

    # -- K. the kernel microbench path, then K2 at the graph's shape -------
    g_src, g_dst = live_edges(svc.graph)
    g_dst32 = g_dst.to(torch.int32)
    feats = quantized_features(n, SEG_FEATURES, seg_rng, dev)
    t0 = time.monotonic()
    with counts.path("kernels"):
        q_row, = KB.query_kernel_vs_plain(seed=args.seed)
        s_row, = KB.segment_matmul_vs_segment_sum(seed=args.seed)
        agg = gather_scatter(feats, g_src, g_dst, n)
        torch.cuda.synchronize()
    kernels_s = time.monotonic() - t0
    msgs = torch.index_select(feats, 0, g_src)
    g_longest = segment_matmul_work(msgs, g_dst32, n)[2]
    if g_longest >= 1 << 16:
        raise AssertionError(f"a segment of {g_longest} edges: sums of the "
                             f"quantized features are no longer exact")
    if not torch.equal(agg, segment_matmul_ref(msgs, g_dst32, n)):
        raise AssertionError("gather_scatter at the graph's shape differs "
                             "from the plain version (exact sums)")
    msgs16 = msgs.to(torch.bfloat16)
    # N(0, 1) messages: the order of summation shows in the floats
    normal = torch.randn(msgs.shape, generator=torch.Generator(
        "cuda").manual_seed(args.seed), device=dev)
    # the BFS relaxation form: D = 1, counts of a random frontier, n + 1
    # segments
    cnt = torch.from_numpy(seg_rng.integers(1, 5, n + 1)).to(dev)
    frontier = torch.from_numpy(seg_rng.random(n + 1) < 0.5).to(dev)
    frontier[n] = False
    relax = torch.where(frontier[g_src], cnt[g_src], 0).float()[:, None]
    relaxed = B.edge_relax(g_src, g_dst, cnt, frontier)
    # both designs at the graph's shapes (the plan picks the sorted one):
    # the quantized features exactly in f32 and bf16; the N(0, 1) messages
    # bit for bit across two launches and within the error bound of fp32
    # summation of the float64 sum; the relaxation equal to the int64
    # edge_relax
    g_err = 0.0
    for design, run in seg_designs.items():
        for x in (msgs, msgs16):
            if not torch.equal(run(x, g_dst32, n),
                               segment_matmul_ref(x, g_dst32, n)):
                raise AssertionError(f"segment_matmul {design} {x.dtype} at "
                                     f"the graph's shape differs from the "
                                     f"plain version (exact sums)")
        got = run(normal, g_dst32, n)
        again = run(normal, g_dst32, n)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"segment_matmul {design}: two launches at "
                                 f"the graph's shape differ")
        g_err = max(g_err, check_summation_bound(
            f"segment_matmul {design} at the graph's shape", got, normal,
            g_dst32, n, design))
        got = run(relax, g_dst32, n + 1)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0].long(), relaxed):
            raise AssertionError(f"segment_matmul {design} differs from "
                                 f"edge_relax on the graph's relaxation")
    del got, again
    # the times of both designs, index_add_ and the plain version at each
    # shape, SEG_REPS rounds in turn; the card's busy time per call of the
    # planned design and of index_add_ from a trace of back-to-back calls
    mb_vals, mb_dst = (torch.from_numpy(x).to(dev)
                       for x in KB.segment_inputs(seed=args.seed))
    seg_shapes = []
    for tag, x, n_seg, ids, order in (
            ("microbench", mb_vals, s_row["nodes"], mb_dst, "sorted"),
            ("graph f32", normal, n, g_dst32, "graph slots (unsorted)"),
            ("graph bf16", msgs16, n, g_dst32, "graph slots (unsorted)"),
            ("relaxation", relax, n + 1, g_dst32, "graph slots (unsorted)")):
        ids64 = ids.long()
        design = SM.plan(x.shape[0], n_seg, x.shape[1], x.dtype)
        calls = {"sorted": lambda: SM._sorted_cuda(x, ids, n_seg),
                 "blocked": lambda: SM._blocked_cuda(x, ids, n_seg),
                 "index_add_": lambda: torch.zeros(
                     (n_seg, x.shape[1]), dtype=x.dtype,
                     device=dev).index_add_(0, ids64, x)}
        reps = {k: [] for k in calls}
        for _ in range(SEG_REPS):
            for k, fn in calls.items():
                reps[k].append(cuda_ms(fn, 50))
        busy = {k: device_busy_ms(lambda: [calls[k]() for _ in range(
            SEG_TRACE_CALLS)])[0] for k in (design, "index_add_")}
        nbytes, _, longest = segment_matmul_work(x, ids, n_seg)
        seg_shapes.append({
            "shape": tag, "edges": x.shape[0], "nodes": n_seg,
            "d": x.shape[1], "dtype": str(x.dtype).split(".")[-1],
            "dst": order, "longest_segment": longest, "design": design,
            "ms": float(np.median(reps[design])),
            "sorted_ms": reps["sorted"], "blocked_ms": reps["blocked"],
            "device_ms": busy[design] and busy[design] / SEG_TRACE_CALLS,
            "plain_ms": cuda_ms(lambda: segment_matmul_ref(x, ids, n_seg),
                                20),
            "library_ms": float(np.median(reps["index_add_"])),
            "index_add_ms": reps["index_add_"],
            "library_device_ms": busy["index_add_"] and busy[
                "index_add_"] / SEG_TRACE_CALLS,
            "sort_ms": cuda_ms(lambda: torch.sort(ids, stable=True), 50),
            "bytes": nbytes})
        if tag == "microbench":
            seg_shapes[-1].update(bench_ms=s_row["kernel_ms"],
                                  bench_index_add_ms=s_row["index_add_ms"])
    seg_shapes[-1]["edge_relax_ms"] = cuda_ms(
        lambda: B.edge_relax(g_src, g_dst, cnt, frontier), 50)
    for row in seg_shapes:
        row["bound_ms"], row["bound_by"] = bound_ms(
            row["bytes"], row["edges"] * row["d"])
        log(f"segment_matmul {row['shape']}: {json.dumps(row)} on {card}")
    log(f"kernels path: {kernels_s:.3f} s; spc_query microbench "
        f"{json.dumps(q_row)}; gather_scatter over {g_src.numel()} edge "
        f"slots x {SEG_FEATURES} into {n} segments equal to plain (exact, "
        f"f32 and bf16, both designs); N(0, 1) max |diff| {g_err:.3g} from "
        f"the float64 sum; relaxation equal to edge_relax; on {card}")
    del (g_src, g_dst, g_dst32, feats, agg, msgs, msgs16, normal, relax, cnt,
         frontier, relaxed, mb_vals, mb_dst, x, ids, ids64, calls)
    gc.collect()
    torch.cuda.empty_cache()

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

    # -- L. the LM serving path (examples/serve_lm.py at qwen2-1.5b) --------
    del svc, store, ana, maint, pinned, view, frozen, served, outs, rows
    gc.collect()
    torch.cuda.empty_cache()
    # one card, no mesh: tp = 1 keeps the published 12 query heads (the
    # reference's CONFIG pads them to 16 for a 16-way model axis)
    lm_cfg = dataclasses.replace(QWEN_CONFIG, tp=1)
    decode_32k = LM_SHAPES["decode_32k"].dims
    lm_reduced = [f"global_batch {decode_32k['global_batch']}->{LM_BATCH}"]
    log(f"lm reduced: {json.dumps(lm_reduced)} (context "
        f"{decode_32k['seq_len']} kept)")
    t0 = time.monotonic()
    params = tf.init_params(
        lm_cfg, generator=torch.Generator("cuda").manual_seed(args.seed),
        device=dev)
    torch.cuda.synchronize()
    log(f"L1: {lm_cfg.name} at tp 1: {lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, {lm_cfg.padded_heads} query / "
        f"{lm_cfg.n_kv_heads} KV heads of {lm_cfg.d_head}, d_ff "
        f"{lm_cfg.d_ff}, vocab {lm_cfg.padded_vocab}; "
        f"{tf.param_bytes(params)} parameter bytes in {lm_cfg.param_dtype} "
        f"({time.monotonic() - t0:.2f} s on {card})")
    s_max = LM_PROMPT + LM_STEPS
    prompts = lm_prompts(lm_cfg, args.seed, dev)
    torch.cuda.reset_peak_memory_stats()
    with counts.path("lm"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = prefill_in_groups(params, lm_cfg, prompts, s_max,
                                          LM_GROUP)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        prefill_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        fed, last, cache, step_ms = greedy_decode(
            params, lm_cfg, cache, logits.argmax(dim=-1).to(torch.int32),
            LM_STEPS)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        decode_peak = torch.cuda.max_memory_allocated()
    # the last steps again under the profiler: the card's busy time per
    # step (outside the lm path: the replay counts nowhere)
    busy_ms, span_ms = device_busy_ms(lambda: replay_decode(
        params, lm_cfg, cache, fed[:, -LM_TRACE_STEPS:],
        s_max - LM_TRACE_STEPS))
    # the same steps again, the card's ms per step by kernel
    step_kernels = device_ms_by_kernel(lambda: replay_decode(
        params, lm_cfg, cache, fed[:, -LM_TRACE_STEPS:],
        s_max - LM_TRACE_STEPS), LM_TRACE_STEPS)
    step_kernels = dict(sorted(step_kernels.items(),
                               key=lambda kv: -kv[1])[:LM_TOP_KERNELS])
    want_launches = lm_cfg.n_layers * LM_STEPS
    if counts.by_path["lm"]["flash_decode"] != want_launches:
        raise AssertionError(f"flash_decode launched "
                             f"{counts.by_path['lm']['flash_decode']} times "
                             f"on the lm path, want {want_launches}")
    if not (torch.isfinite(logits).all() and torch.isfinite(last).all()):
        raise AssertionError("lm: non-finite logits")
    if tuple(last.shape) != (LM_BATCH, lm_cfg.padded_vocab) or \
            cache["lengths"].tolist() != [s_max] * LM_BATCH:
        raise AssertionError(f"lm: logits {tuple(last.shape)}, lengths "
                             f"{cache['lengths'].tolist()}")
    lm_numbers = {
        "requests": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS,
        "prefill_group": LM_GROUP, "prefill_s": prefill_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "prefill_peak_bytes": prefill_peak,
        "decode_s": decode_s,
        "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
        "decode_step_ms_p90": float(np.percentile(step_ms, 90)),
        "decode_tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
        "decode_peak_bytes": decode_peak,
        "kv_cache_bytes": 2 * cache["k"].numel() * cache["k"].element_size(),
        "param_bytes": tf.param_bytes(params), "reduced": lm_reduced,
        "decode_busy_ms_per_step": busy_ms and busy_ms / LM_TRACE_STEPS,
        "decode_idle_share": busy_ms and 1 - busy_ms / LM_TRACE_STEPS / (
            float(np.percentile(step_ms, 50))),
        "decode_step_ms_by_kernel": step_kernels}
    log(f"L2: prefill {LM_BATCH} x {LM_PROMPT} tokens in groups of "
        f"{LM_GROUP}: {prefill_s:.3f} s, peak {prefill_peak} B on "
        f"{card}")
    log(f"L3: {LM_STEPS} decode steps x {LM_BATCH} requests: "
        f"{decode_s:.3f} s, step p50 {lm_numbers['decode_step_ms_p50']:.3f} "
        f"ms p90 {lm_numbers['decode_step_ms_p90']:.3f} ms, "
        f"{lm_numbers['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{decode_peak} B; flash_decode launched {want_launches} times on "
        f"{card}")
    log(f"L3 trace by kernel, device ms per step (the top "
        f"{LM_TOP_KERNELS}): {json.dumps(step_kernels)} on {card}")
    log("L3 trace: " + (
        f"{LM_TRACE_STEPS} steps replayed under torch.profiler, the card "
        f"busy {busy_ms:.3f} ms of {span_ms:.3f} ms from its first to its "
        f"last device event; busy {busy_ms / LM_TRACE_STEPS:.3f} ms per "
        f"step, idle share {lm_numbers['decode_idle_share']:.4f} of the "
        f"step p50" if busy_ms else "the profiler saw no device event; "
        "busy time not measured") + f" on {card}")

    t0 = time.monotonic()
    check_cache = {"k": cache["k"][:, :LM_CHECK].clone(),
                   "v": cache["v"][:, :LM_CHECK].clone(),
                   "lengths": cache["lengths"][:LM_CHECK].clone()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fault_span = lm_fault_span(lm_cfg, sms)
    l4 = lm_consistency(params, lm_cfg, prompts[:LM_CHECK], fed[:LM_CHECK],
                        last[:LM_CHECK], check_cache, s_max, fault_span)
    del check_cache
    lm_numbers.update(consistency=l4)
    log(f"L4: prefill of {LM_CHECK} x {LM_PROMPT + LM_STEPS} tokens vs the "
        f"last decode step: relative L2 {l4['decode']:.4g} (limit "
        f"{LM_REL_TOL}), argmax agrees on {l4['argmax']}/{LM_CHECK}; the "
        f"fed tokens again from the prompts' cache: {l4['replay']:.4g} on "
        f"the port's route, planted faults {l4['bf16_scores']:.4g} (scores "
        f"and probabilities in bf16) and {l4['drop_span']:.4g} (first "
        f"{fault_span} positions, one span of the kernel at the main "
        f"path's shape, left out) ({time.monotonic() - t0:.3f} "
        f"s on {card})")
    check_l4(l4)
    del params, logits, prompts
    gc.collect()
    torch.cuda.empty_cache()

    log(f"launches on the main paths: {json.dumps(counts.by_path)}")
    counts.check()

    # -- flash_decode at the main path's shape, and its times -----------------
    k0, v0, lens = cache["k"][0], cache["v"][0], cache["lengths"].clone()
    qm = torch.randn((LM_BATCH, lm_cfg.padded_heads, lm_cfg.d_head),
                     generator=torch.Generator("cuda").manual_seed(args.seed),
                     device=dev).to(torch.bfloat16)
    fd_route = FD.plan(LM_BATCH, lm_cfg.n_kv_heads, lm_cfg.padded_heads,
                       int(k0.shape[1]), lm_cfg.d_head, torch.bfloat16,
                       sms).route
    got = FD.flash_decode_cuda(qm, k0, v0, lens)
    again = FD.flash_decode_cuda(qm, k0, v0, lens)
    old = FD._simt_cuda(qm, k0, v0, lens)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash_decode: two launches at the main path's "
                             "shape differ")
    q32, k32, v32 = qm.float(), k0.float(), v0.float()
    want = decode_attention_ref(q32, k32, v32, lens)
    main_err = check_close(f"flash_decode ({fd_route}) at the main path's "
                           f"shape (bf16)", got, want, MAIN_RTOL, MAIN_ATOL)
    main_rel = rel_l2(got, want)
    simt_err = check_close("flash_decode (simt) at the main path's shape "
                           "(bf16)", old, want, MAIN_RTOL, MAIN_ATOL)
    simt_rel = rel_l2(old, want)
    del again, old
    got32 = FD.flash_decode_cuda(q32, k32, v32, lens)
    torch.cuda.synchronize()
    main_err32 = check_close("flash_decode at the main path's shape (f32)",
                             got32, want, 2e-5, 2e-5)
    # the bf16 check must fail a kernel that left out its last span
    lost = decode_attention_ref(q32, k32, v32, lens - fault_span).to(
        torch.bfloat16).double()
    lost_err = float((lost - want.double()).abs().max())
    if torch.allclose(lost, want.double(), rtol=MAIN_RTOL, atol=MAIN_ATOL):
        raise AssertionError(f"the main-shape check passes a kernel that "
                             f"leaves out a span (max |diff| {lost_err})")
    del q32, k32, v32, got32, lost
    log(f"flash_decode at the main path's shape == plain: bf16 on the "
        f"{fd_route} route max |diff| {main_err:.3g} (rtol {MAIN_RTOL}, atol "
        f"{MAIN_ATOL}), relative L2 {main_rel:.3g}, bitwise equal across two "
        f"launches; on the simt route {simt_err:.3g}, relative L2 "
        f"{simt_rel:.3g}; output RMS "
        f"{float(want.norm()) / want.numel() ** 0.5:.3g}; "
        f"f32 max |diff| {main_err32:.3g} (2e-5); one span of "
        f"{fault_span} left out differs by {lost_err:.3g} and fails on "
        f"{card}")
    length = int(lens[0])
    if lens.tolist() != [length] * LM_BATCH:
        raise AssertionError(f"unequal lengths {lens.tolist()}")
    ks = k0[:, :length].transpose(1, 2).contiguous()    # [B, KVH, L, D]
    vs = v0[:, :length].transpose(1, 2).contiguous()
    lib = F.scaled_dot_product_attention(qm[:, :, None], ks, vs,
                                         enable_gqa=True)[:, :, 0]
    check_close("F.scaled_dot_product_attention", lib, want, MAIN_RTOL,
                MAIN_ATOL)
    del want
    # the planned route, the CUDA-core route and SDPA in turn
    fd_calls = {fd_route: lambda: FD.flash_decode_cuda(qm, k0, v0, lens),
                "simt": lambda: FD._simt_cuda(qm, k0, v0, lens),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    qm[:, :, None], ks, vs, enable_gqa=True)}
    fd_reps = {k: [] for k in fd_calls}
    for _ in range(FD_REPS):
        for k, fn in fd_calls.items():
            fd_reps[k].append(cuda_ms(fn, 100))
    fd_ms = float(np.median(fd_reps[fd_route]))
    fd_lib_ms = float(np.median(fd_reps["sdpa"]))
    # what the card runs in one call: each kernel's device ms per call
    # flash_decode's kernels in the decode step's trace (28 calls a step)
    fd_trace = {k: v / lm_cfg.n_layers for k, v in step_kernels.items()
                if k.startswith("flash_decode")}
    fd_plain_ms = cuda_ms(lambda: decode_attention_ref(qm, k0, v0, lens), 5,
                          warmup=1)
    fd_bytes, fd_ops = flash_decode_work(qm, k0, lens)
    fd_bound, fd_by = bound_ms(fd_bytes, fd_ops)
    fd_shape = {"B": LM_BATCH, "H": lm_cfg.padded_heads,
                "KVH": lm_cfg.n_kv_heads, "S": int(k0.shape[1]),
                "D": lm_cfg.d_head, "lengths": length, "dtype": "bfloat16"}
    log(f"flash_decode at {json.dumps(fd_shape)}: {fd_route} "
        f"{json.dumps(fd_reps[fd_route])} ms, simt "
        f"{json.dumps(fd_reps['simt'])} ms, SDPA {json.dumps(fd_reps['sdpa'])} "
        f"ms in {FD_REPS} rounds; median {fd_ms:.5f} ms "
        f"({fd_bytes / fd_ms / 1e6:.1f} GB/s), plain {fd_plain_ms:.4f} ms, "
        f"SDPA {fd_lib_ms:.5f} ms, bound {fd_bound:.5f} ms ({fd_bytes} B, "
        f"{fd_by}); {lm_cfg.n_layers} launches take "
        f"{lm_cfg.n_layers * fd_ms:.3f} ms of a "
        f"{lm_numbers['decode_step_ms_p50']:.3f} ms step on {card}")
    log(f"flash_decode in the L3 trace, device ms per call by kernel: "
        f"{json.dumps(fd_trace)} on {card}")
    log(f"lm: {json.dumps(lm_numbers)} on {card}")
    del cache, k0, v0, ks, vs

    def paths_of(kernel):
        return [p for p, names in PATH_KERNELS.items() if kernel in names]

    def usage_of(kernel):
        return {f["function"]: [f["registers"], f["smem"], f["spill_stores"],
                                f["spill_loads"]]
                for f in usage.get(kernel, [])}

    kernels = [{
        "name": "spc_query", "route": "cuda",
        "path": paths_of("spc_query"), "ptxas": usage_of("spc_query"),
        "source": KERNEL_SOURCES["spc_query"][0],
        "replaces": KERNEL_SOURCES["spc_query"][1],
        "launches": counts.of("spc_query")[0],
        "launches_by_path": counts.of("spc_query")[1], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "plain_merge_ms": merge_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "microbench": q_row,
    }, {
        "name": "segment_matmul", "route": "cuda",
        "path": paths_of("segment_matmul"),
        "ptxas": usage_of("segment_matmul"),
        "design": seg_shapes[1]["design"],
        "microbench_design": seg_shapes[0]["design"],
        "source": KERNEL_SOURCES["segment_matmul"][0],
        "replaces": KERNEL_SOURCES["segment_matmul"][1],
        "launches": counts.of("segment_matmul")[0],
        "launches_by_path": counts.of("segment_matmul")[1],
        "max_abs_err": seg_err, "bf16_max_abs_err": seg_err16,
        "graph_max_abs_err_vs_float64": g_err, "deterministic": True,
        "chunk": SM.CHUNK, **{k: seg_shapes[1][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": seg_shapes[1]["shape"], "shapes": seg_shapes,
    }, {
        "name": "embedding_bag", "route": "cuda",
        "path": paths_of("embedding_bag"),
        "ptxas": usage_of("embedding_bag"),
        "source": KERNEL_SOURCES["embedding_bag"][0],
        "replaces": KERNEL_SOURCES["embedding_bag"][1],
        "launches": counts.of("embedding_bag")[0],
        "launches_by_path": counts.of("embedding_bag")[1],
        "max_abs_err": bag_err,
        "ms": bag_ms, "plain_ms": bag_plain_ms, "bound_ms": bag_bound,
        "bound_by": bag_by, "library_ms": bag_lib_ms,
        "shape": list(bags.shape), "shapes": bag_shapes,
    }, {
        "name": "flash_decode", "route": "cuda",
        "path": paths_of("flash_decode"), "ptxas": usage_of("flash_decode"),
        "design": fd_route, "ms_rounds": fd_reps[fd_route],
        "trace_ms_per_call": fd_trace,
        "simt_ms": fd_reps["simt"], "library_ms_rounds": fd_reps["sdpa"],
        "main_simt_max_abs_err": simt_err, "main_simt_rel_l2": simt_rel,
        "fault_span": fault_span,
        "source": KERNEL_SOURCES["flash_decode"][0],
        "replaces": KERNEL_SOURCES["flash_decode"][1],
        "launches": counts.of("flash_decode")[0],
        "launches_by_path": counts.of("flash_decode")[1],
        "max_abs_err": max(dec_err, dec_err16, main_err, main_err32),
        "f32_max_abs_err": dec_err,
        "main_max_abs_err": main_err, "main_rel_l2": main_rel,
        "main_f32_max_abs_err": main_err32, "main_tol": [MAIN_RTOL, MAIN_ATOL],
        "main_lost_span_max_abs_err": lost_err,
        "ms": fd_ms, "plain_ms": fd_plain_ms, "bound_ms": fd_bound,
        "bound_by": fd_by, "bytes": fd_bytes, "library_ms": fd_lib_ms,
        "shape": fd_shape,
    }]
    log(f"chip_smoke: {time.monotonic() - start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
