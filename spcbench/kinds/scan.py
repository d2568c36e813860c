"""scan: one analytics caller in a closed loop of bulk pair batches.

Parameters (the traffic file): ``batch_pairs`` pairs a request,
``distinct_batches`` batches drawn in set-up and cycled, ``source_skew``
``uniform`` or ``zipf-<s>`` (YCSB's Zipfian over a seeded permutation
of the vertices; targets uniform), ``trace_requests`` batches profiled
at the window's start in a traced run, and the sample judged:
``check_sources`` sources (the hottest among them under a skew) and at
most ``check_pairs_per_batch`` of their pairs in each batch.

Each request goes through ``SPCService.reader(consistency="pinned")``
and its answers are copied to the host, into page-locked buffers made
in the warm-up in the answers' own dtypes; the latency runs from the
call to the answers on the host.  The sampled answers of every batch in
the window are kept and judged once the window has closed, with the
width of their counts and of the index's count table.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from spcbench.check import as_answered, mismatches, narrow
from spcbench.reference.spc_bfs import Graph, answer


def _sources(n: int, size: int, skew: str, rng) -> np.ndarray:
    if skew == "uniform":
        return rng.integers(0, n, size=size)
    if not skew.startswith("zipf-"):
        raise ValueError(f"unknown source_skew {skew!r}")
    theta = float(skew[len("zipf-"):])
    perm = rng.permutation(n)
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -theta)
    rank = np.searchsorted(cdf, rng.random(size) * cdf[-1])
    return perm[np.minimum(rank, n - 1)]


class Kind:
    """The scan driver: batches and the judged sample drawn in set-up,
    the window, and the judgement of the kept answers."""

    def __init__(self, n: int, edges: np.ndarray, traffic: dict,
                 traffic_seed, sample_seed) -> None:
        self.n, self.edges = n, edges
        self.trace_requests = int(traffic["trace_requests"])
        b = int(traffic["batch_pairs"])
        rng = np.random.default_rng(traffic_seed)
        self.batches = [
            (_sources(n, b, traffic["source_skew"], rng),
             rng.integers(0, n, size=b))
            for _ in range(int(traffic["distinct_batches"]))]
        # the judged sample: every batch's pairs from a few sources,
        # the hottest source of all the batches among them
        rs = np.random.default_rng(sample_seed)
        seen, freq = np.unique(np.concatenate([s for s, _ in self.batches]),
                               return_counts=True)
        chosen = rs.choice(seen, size=min(int(traffic["check_sources"]),
                                          seen.size), replace=False)
        chosen[0] = seen[np.argmax(freq)]
        cap = int(traffic["check_pairs_per_batch"])
        self.pos = []
        for s, _ in self.batches:
            at = np.flatnonzero(np.isin(s, chosen))
            if at.size > cap:
                at = np.sort(rs.choice(at, size=cap, replace=False))
            self.pos.append(at)
        self.records = []
        self.buffers = {}
        self.index_count_dtype = None

    def to_host(self, x):
        """``x`` as a numpy array on the host: a copy into the
        page-locked buffer of its shape and dtype (made at its first
        use, in the warm-up), or ``x`` itself off the card."""
        if x.device.type != "cuda":
            return x.numpy()
        import torch
        key = (tuple(x.shape), x.dtype)
        buf = self.buffers.get(key)
        if buf is None:
            buf = self.buffers[key] = torch.empty(
                x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf.numpy()

    def warm(self, svc) -> None:
        serve = svc.reader(consistency="pinned")
        d, c = serve(*self.batches[0])
        self.to_host(d), self.to_host(c)

    def window(self, svc, seconds: float, tracer) -> dict:
        serve = svc.reader(consistency="pinned")
        lat, failed, errors, pairs, traced_n = [], 0, [], 0, 0
        k_count = len(self.batches)
        if tracer is not None:
            tracer.begin()
        t_start = time.perf_counter()
        i = 0
        while True:
            k = i % k_count
            s, t = self.batches[k]
            traced = tracer is not None and tracer.active
            ctx = (tracer.request("spcbench.scan") if traced
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with ctx:
                    d, c = serve(s, t)
                    d, c = self.to_host(d), self.to_host(c)
            except Exception as e:  # a request that never answers
                failed += 1
                errors.append(repr(e))
                d = None
            t1 = time.perf_counter()
            i += 1
            traced_n += traced
            if traced and i >= self.trace_requests:
                tracer.end()
            if d is not None:
                lat.append(t1 - t0)
                pairs += s.size
                p = self.pos[k]
                self.records.append((k, d[p], c[p]))
            if t1 - t_start >= seconds:
                break
        if tracer is not None:
            tracer.end()
        return {"requests": i, "failed": failed, "errors": errors[:3],
                "elapsed_s": t1 - t_start, "pairs": pairs,
                "latencies_s": lat, "traced": traced_n}

    def collect(self, svc) -> dict:
        """What a reader of the trace needs from the program's state
        (read after the window): each label row's used entries; and the
        dtype of the index's count table, for the judgement."""
        index = svc.store.current().index
        self.index_count_dtype = index.cnt.dtype
        return {"row_sizes": index.size.cpu().numpy()}

    def final_edges(self) -> np.ndarray:
        return self.edges

    def _wanted(self, graph: Graph) -> list:
        return [answer(graph, s[p], t[p])
                for (s, t), p in zip(self.batches, self.pos)]

    def judge(self, graph: Graph) -> tuple:
        """Compare every kept answer with the reference, and count the
        count arrays held narrower than int64."""
        want = self._wanted(graph)
        bad = checked = 0
        for k, d, c in self.records:
            bad += mismatches(self.n, d, c, *want[k])
            checked += d.size
        widths = [c.dtype for _, _, c in self.records]
        widths.append(self.index_count_dtype)
        return {"mismatched_pairs": bad, "narrow_counts": narrow(widths)}, \
            checked

    def control(self, graph: Graph, count_dtype) -> tuple:
        """The control in the program's place: the reference counting in
        ``count_dtype``, judged as a run is on the same sampled pairs of
        every distinct batch."""
        bad = checked = 0
        widths = []
        for (s, t), p, (wd, wc) in zip(self.batches, self.pos,
                                       self._wanted(graph)):
            d, c = as_answered(self.n, *answer(graph, s[p], t[p], count_dtype))
            bad += mismatches(self.n, d, c, wd, wc)
            checked += wd.size
            widths.append(c.dtype)
        return {"mismatched_pairs": bad, "narrow_counts": narrow(widths)}, \
            checked
