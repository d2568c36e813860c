"""Kernel microbenchmarks of the port (port of
``benchmarks/kernels_bench.py``).

    python -m repro_torch.bench.kernels_bench

``query_kernel_vs_plain`` times the spc_query kernel against its plain
version (the L x L table) on b pairs of l labels each;
``segment_matmul_vs_segment_sum`` times the segment_matmul kernel (the
design its ``plan`` picks: at the defaults the blocked one) against its
plain version and one ``index_add_`` call on e edges into n segments of
width d, ids sorted.  Both draw their inputs with numpy in
the reference's order of generator calls, so a seed gives the
reference's inputs (counts int64 here, float32 there).  Hub rows are
sorted draws from [0, 500), so a hub often repeats within a row.

On the card each function first holds the kernel against its plain
version, spc_query exactly and segment_matmul within rtol = atol = 1e-6,
and raises on a mismatch; then it times each from CUDA events after a
warm-up.  segment_matmul's plain version is held on the CPU copy of the
inputs: there ``index_add_`` adds in index order, the same sums on
every run, where on the card its float atomics add in an order that
changes from run to run (by a few ulps of the partial sums).  With ``device="cpu"`` only the plain versions run, timed on
the host clock, and the kernel columns are None.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.kernels.segment_matmul.kernel import (chunks, plan,
                                                       segment_matmul_cuda)
from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
from repro_torch.kernels.spc_query.kernel import spc_query_cuda
from repro_torch.kernels.spc_query.ref import spc_query_ref

#: Timed calls after one warm-up call, on the card and on the CPU.
CARD_ITERS, CPU_ITERS = 50, 5


def _bench_ms(fn, dev: torch.device) -> float:
    """Mean milliseconds of ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CARD_ITERS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / CARD_ITERS
    t0 = time.perf_counter()
    for _ in range(CPU_ITERS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / CPU_ITERS


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def query_inputs(b: int = 4096, l: int = 64, seed: int = 0):
    """(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t) numpy [b, l]: hub and
    dist int32, cnt int64, drawn as the reference's microbench draws
    them."""
    r = np.random.default_rng(seed)

    def hub():
        return np.sort(r.integers(0, 500, (b, l))).astype(np.int32)

    def dist():
        return r.integers(0, 20, (b, l)).astype(np.int32)

    def cnt():
        return r.integers(1, 9, (b, l)).astype(np.int64)

    return (hub(), dist(), cnt(), hub(), dist(), cnt())


def segment_inputs(e: int = 16384, n: int = 2048, d: int = 128,
                   seed: int = 0):
    """(vals float32 [e, d], dst int32 [e] sorted over [0, n)), drawn as
    the reference's microbench draws them."""
    r = np.random.default_rng(seed)
    vals = r.normal(size=(e, d)).astype(np.float32)
    dst = np.sort(r.integers(0, n, e)).astype(np.int32)
    return vals, dst


def query_kernel_vs_plain(b: int = 4096, l: int = 64, seed: int = 0, *,
                          device="cuda") -> list:
    """spc_query kernel vs its plain version: microseconds per query."""
    dev = resolve_device(device)
    rows = tuple(torch.from_numpy(x).to(dev) for x in query_inputs(b, l,
                                                                   seed))
    kernel_us = None
    if dev.type == "cuda":
        d, c = spc_query_cuda(*rows)
        d_p, c_p = spc_query_ref(*rows)
        if not (torch.equal(d, d_p) and torch.equal(c, c_p)):
            raise RuntimeError("spc_query: the kernel differs from its "
                               "plain version on the microbench rows")
        kernel_us = _bench_ms(lambda: spc_query_cuda(*rows), dev) / b * 1e3
    plain_us = _bench_ms(lambda: spc_query_ref(*rows), dev) / b * 1e3
    out = [{"name": "spc_query", "device": _device_name(dev), "batch": b,
            "l_cap": l, "kernel_us_per_q": kernel_us,
            "plain_us_per_q": plain_us}]
    _print(out)
    return out


def segment_matmul_vs_segment_sum(e: int = 16384, n: int = 2048,
                                  d: int = 128, seed: int = 0, *,
                                  device="cuda") -> list:
    """segment_matmul kernel vs its plain version and ``index_add_``:
    milliseconds per call."""
    dev = resolve_device(device)
    vals, dst = (torch.from_numpy(x).to(dev) for x in segment_inputs(
        e, n, d, seed))
    kernel_ms = None
    if dev.type == "cuda":
        got = segment_matmul_cuda(vals, dst, n)
        want = segment_matmul_ref(vals.cpu(), dst.cpu(), n).to(dev)
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise RuntimeError(
                f"segment_matmul: the kernel differs from its plain version "
                f"by {float((got - want).abs().max())} (rtol = atol = 1e-6)")
        kernel_ms = _bench_ms(lambda: segment_matmul_cuda(vals, dst, n), dev)
    plain_ms = _bench_ms(lambda: segment_matmul_ref(vals, dst, n), dev)
    # the same function in one library call (every id here is in range)
    dst64 = dst.long()
    library_ms = _bench_ms(lambda: torch.zeros(
        (n, d), dtype=vals.dtype, device=dev).index_add_(0, dst64, vals), dev)
    longest = int(torch.bincount(dst64, minlength=1).max()) if e else 0
    out = [{"name": "segment_matmul", "device": _device_name(dev),
            "edges": e, "nodes": n, "d": d, "longest_segment": longest,
            "design": plan(e, n, d, vals.dtype), "chunks": chunks(e),
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "index_add_ms": library_ms}]
    _print(out)
    return out


def _print(rows) -> None:
    cols = list(rows[0])
    print(",".join(cols))
    for r in rows:
        print(",".join(str(r[c]) for c in cols))
    print()


if __name__ == "__main__":
    query_kernel_vs_plain()
    segment_matmul_vs_segment_sum()
