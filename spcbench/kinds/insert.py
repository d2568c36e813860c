"""insert: one writer session in a closed loop of edge-insert tickets.

Parameters (the traffic file): ``events_per_ticket`` fresh non-edge
inserts a ticket (the insert protocol of the program's ``graph_stream``,
no deletes), their endpoints drawn in ``endpoint_strata`` fixed blocks
of the degree order (:func:`spcbench.graphgen.insert_stream`), so that
every seed inserts the same mix of heavy and light endpoints;
``tickets`` drawn in set-up (more than any window uses),
``warmup_tickets`` applied in set-up, ``trace_requests`` tickets
profiled from the window's start in a traced run (more than a window
applies: all of them), ``window_tickets``, about what a window applies
(the control's final graph), and the judged sources:
the endpoints of the last applied ticket's events and of
``check_events`` more applied events drawn from the seed, and
``check_random_sources`` vertices.

Each ticket goes through ``Session.submit`` and then
``SPCService.wait_for_ticket``, so it is applied and published before
the next one.  The window ends when the first ticket that finishes
after ``--seconds`` is applied; the rate is the events applied over all
of that time.  Once the window has closed, the index that maintenance
produced is read back through a pinned reader at the last applied
version, every judged source against every vertex, and judged against
the reference on the graph with every applied event, with the width of
the counts read back and of the index's count table.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from spcbench import graphgen
from spcbench.check import as_answered, mismatches, narrow
from spcbench.reference.spc_bfs import Graph, answer

#: Pairs a read-back call asks for at most (the configuration's
#: query_batch).
READ_PAIRS = 1 << 20


class Kind:
    """The insert driver: tickets and the judged sources drawn in set-up,
    the window, the read-back and its judgement."""

    def __init__(self, n: int, edges: np.ndarray, traffic: dict,
                 traffic_seed, sample_seed) -> None:
        self.n, self.edges = n, edges
        self.per = int(traffic["events_per_ticket"])
        self.warmup = int(traffic["warmup_tickets"])
        self.trace_requests = int(traffic["trace_requests"])
        self.window_tickets = int(traffic["window_tickets"])
        self.stream = graphgen.insert_stream(
            edges, n, int(traffic["tickets"]) * self.per, traffic_seed,
            strata=int(traffic["endpoint_strata"]))
        rs = np.random.default_rng(sample_seed)
        self.extra = rs.integers(0, n, size=int(traffic["check_random_sources"]))
        self.pick = rs.random(int(traffic["check_events"]))
        self.applied = 0          # tickets applied and published
        self.last_ticket = None
        self.read = None

    def _ticket(self, i: int) -> list:
        ev = self.stream[i * self.per:(i + 1) * self.per]
        return [("+", int(a), int(b)) for a, b in ev]

    def warm(self, svc) -> None:
        sess = svc.session()
        for _ in range(self.warmup):
            svc.wait_for_ticket(sess.submit(self._ticket(self.applied)),
                                timeout=600)
            self.applied += 1

    def window(self, svc, seconds: float, tracer) -> dict:
        from repro_torch.core.bfs import frontier_syncs
        sess = svc.session()
        lat, failed, errors, events = [], 0, [], 0
        tickets = self.stream.shape[0] // self.per
        syncs0 = frontier_syncs.count
        if tracer is not None:
            tracer.begin()
        t_start = t1 = time.perf_counter()
        i = 0
        while True:
            if self.applied == tickets:
                break             # every ticket drawn is applied
            traced = tracer is not None and tracer.active
            ctx = (tracer.request("spcbench.insert") if traced
                   else contextlib.nullcontext())
            evs = self._ticket(self.applied)
            t0 = time.perf_counter()
            try:
                with ctx:
                    ticket = sess.submit(evs)
                    svc.wait_for_ticket(ticket, timeout=600)
            except Exception as e:  # the updater died or timed out
                failed += len(evs)
                errors.append(repr(e))
                t1 = time.perf_counter()
                break
            t1 = time.perf_counter()
            i += 1
            if traced and i >= self.trace_requests:
                tracer.end()
            self.applied += 1
            self.last_ticket = ticket
            events += len(evs)
            lat.append(t1 - t0)
            if t1 - t_start >= seconds:
                break
        if tracer is not None:
            tracer.end()
        return {"requests": events + failed, "failed": failed,
                "errors": errors[:3], "elapsed_s": t1 - t_start,
                "events": events, "latencies_s": lat,
                "frontier_syncs": frontier_syncs.count - syncs0}

    def sample(self):
        """The judged pairs: every judged source against every vertex."""
        done = self.applied * self.per
        some = (self.pick * done).astype(np.int64)
        last = np.arange(done - self.per, done)
        ends = self.stream[np.concatenate([some, last])].reshape(-1)
        src = np.unique(np.concatenate([ends, self.extra]))
        return (np.repeat(src, self.n),
                np.tile(np.arange(self.n, dtype=np.int64), src.size))

    def collect(self, svc) -> dict:
        """Read the maintained index back through a pinned reader."""
        s, t = self.sample()
        serve = svc.reader(consistency="pinned")
        d, c = [], []
        for lo in range(0, s.size, READ_PAIRS):
            dd, cc = serve(s[lo:lo + READ_PAIRS], t[lo:lo + READ_PAIRS])
            d.append(dd.cpu().numpy())
            c.append(cc.cpu().numpy())
        want = (svc.ticket_version(self.last_ticket)
                if self.last_ticket is not None else serve.last_version)
        self.read = (np.concatenate(d), np.concatenate(c),
                     max(0, (want or 0) - (serve.last_version or 0)),
                     svc.store.current().index.cnt.dtype)
        return {}

    def final_edges(self) -> np.ndarray:
        """The initial edges and every applied event."""
        return np.concatenate([self.edges,
                               self.stream[:self.applied * self.per]])

    def judge(self, graph: Graph) -> tuple:
        """Compare the read-back with the reference on ``graph``."""
        d, c, behind, index_dtype = self.read
        s, t = self.sample()
        bad = mismatches(self.n, d, c, *answer(graph, s, t))
        return {"mismatched_pairs": bad,
                "narrow_counts": narrow([c.dtype, index_dtype]),
                "versions_behind": behind}, s.size

    def control(self, graph: Graph, count_dtype) -> tuple:
        """The control in the program's place: the reference counting in
        ``count_dtype`` on the graph after the window's tickets, judged as
        a read-back is."""
        s, t = self.sample()
        d, c = as_answered(self.n, *answer(graph, s, t, count_dtype))
        bad = mismatches(self.n, d, c, *answer(graph, s, t))
        return {"mismatched_pairs": bad, "narrow_counts": narrow([c.dtype])}, \
            s.size
