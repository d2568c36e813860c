"""Query serving through the SPCService façade: async ingest with
backpressure on the write side, explicit consistency on the read side.

The DSPC premise end-to-end, consumed the way the public API intends:
ONE object -- ``repro_torch.serve.SPCService`` -- owns the updater thread, the
versioned snapshot store and the serving replicas.  A feeder thread
pushes mixed edge-event chunks through ``service.submit`` (bounded
queue: a full queue blocks the feeder, never the readers); the main
thread is a serving replica on a ``pinned`` reader, so every batch pins
one published snapshot and queries keep flowing *during* updates.  At
the end a ``read_your_writes`` reader demonstrates the stronger
consistency level: it blocks until the published version covers the
last accepted submit ticket before answering.

The second phase puts the coalescing ``FrontDoor`` in front of the same
service: many caller threads each hold a per-session handle and submit
single ``(s, t)`` queries; dispatcher threads fold whatever is pending
into one padded engine batch, one session writes through its own ticket
scope and reads its write back (per-session read-your-writes), and the
door's stats show how many dispatches the coalescing saved.

Run:  python -m repro_torch.examples.serve_spc [--n 300 --m 900]
      python -m repro_torch.examples.serve_spc --fast   # CI smoke
"""

import argparse
import threading
import time

import numpy as np

from repro_torch.core.graph import INF, edge_set
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.serve import SPCService
from repro_torch.serve.routing import KINDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--m", type=int, default=900)
    ap.add_argument("--inserts", type=int, default=18)
    ap.add_argument("--deletes", type=int, default=6)
    ap.add_argument("--update-batch", type=int, default=8)
    ap.add_argument("--query-batch", type=int, default=128)
    ap.add_argument("--queue-size", type=int, default=2,
                    help="ingest queue bound (the backpressure point)")
    ap.add_argument("--route", default="auto",
                    choices=[k for k in KINDS if k != "sharded"])
    ap.add_argument("--checkpoint-dir", default=None,
                    help="publish -> durable snapshot directory")
    ap.add_argument("--fast", action="store_true",
                    help="tiny sizes for the CI examples smoke step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.n, args.m = 80, 200
        args.inserts, args.deletes = 6, 3
        args.query_batch = 32

    edges = random_graph_edges(args.n, args.m, seed=0)
    print(f"building service: n={args.n} m={len(edges)}")
    t0 = time.perf_counter()
    service = SPCService(args.n, edges, l_cap=32, route=args.route,
                         update_batch=args.update_batch,
                         queue_size=args.queue_size,
                         checkpoint_dir=args.checkpoint_dir,
                         device=args.device)
    print(f"  built in {time.perf_counter() - t0:.2f}s, "
          f"{service.spc.index_entries()} entries")
    events = graph_stream(edges, args.n, args.inserts, args.deletes, seed=1)
    rng = np.random.default_rng(2)

    with service:
        serve = service.reader()          # pinned: never waits on ingest
        # warm the serving path before the loop (steady-state us)
        serve([0], [0])
        s = rng.integers(0, args.n, args.query_batch)
        t = s  # bound even if ingest outruns the first loop iteration
        serve(s, t)

        # -- feeder thread: chunks through the bounded ingest queue ------
        def feeder():
            for lo in range(0, len(events), args.update_batch):
                service.submit(events[lo:lo + args.update_batch])

        th = threading.Thread(target=feeder)
        t_start = time.perf_counter()
        th.start()

        # -- serving replica: pin a snapshot per batch, never block ------
        served = 0
        while th.is_alive() or service.pending:
            s = rng.integers(0, args.n, args.query_batch)
            t = rng.integers(0, args.n, args.query_batch)
            t0 = time.perf_counter()
            d, c = serve(s, t)
            d, c = d.cpu().numpy(), c.cpu().numpy()   # the answers on the host
            t_q = time.perf_counter() - t0
            served += args.query_batch
            k = int(np.argmin(d))
            dk = "inf" if int(d[k]) >= int(INF) else int(d[k])
            print(f"  v{serve.last_version:02d} | {args.query_batch} "
                  f"queries in {1e3 * t_q:.2f}ms "
                  f"({1e6 * t_q / args.query_batch:.1f}us/q) "
                  f"e.g. spc({int(s[k])},{int(t[k])})=({dk},{int(c[k])})")
        th.join()
        service.drain()
        elapsed = time.perf_counter() - t_start

        # -- read your writes: block until the last ticket is covered ----
        rw = service.reader("read_your_writes")
        rw(s[:4], t[:4])
        last = service.accepted
        print(f"read_your_writes pinned v{rw.last_version} >= "
              f"v{service.ticket_version(last)} (ticket {last})")

        stats = service.stats()           # one frozen cross-thread view
        print(f"replayed {len(events)} events in {last} submits "
              f"({stats['update'].batches} dispatches); published "
              f"version {stats['version']} | served {served} queries "
              f"across versions "
              f"{sorted(sum((list(v.versions) for v in stats['serve']), []))}"
              f" in {elapsed:.2f}s")
        print(f"update stats: {stats['update']}")
        for i, view in enumerate(stats["serve"]):
            if view.batches:
                print(f"replica[{i}] stats: {view}")

        # -- front door: many single-query callers, coalesced ------------
        callers = 4 if args.fast else 8
        per_caller = 24 if args.fast else 120
        with service.frontdoor(max_live_batches=4, dispatchers=2,
                               gather_window_s=0.002) as door:
            def reader_thread(k):
                sess = door.session()     # pinned: snapshot of the moment
                rng_k = np.random.default_rng(100 + k)
                for _ in range(per_caller):
                    sess.query(int(rng_k.integers(0, args.n)),
                               int(rng_k.integers(0, args.n)))

            threads = [threading.Thread(target=reader_thread, args=(k,))
                       for k in range(callers)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            # a writing session alongside the readers: its OWN ticket
            # gates its reads; the reader sessions above never wait on it
            writer = door.session("read_your_writes")
            more = graph_stream(sorted(edge_set(service.spc.graph)),
                                args.n, 4, 2, seed=3)
            ticket = writer.submit(more)
            a, b = more[0][1], more[0][2]
            d, c = writer.query(a, b)     # parks until ticket applies
            for th in threads:
                th.join()
            elapsed = time.perf_counter() - t0
            st = door.stats()
            print(f"front door: {callers} callers x {per_caller} "
                  f"single-pair queries + 1 writer session in "
                  f"{elapsed:.2f}s ({st['requests'] / elapsed:.0f} qps)")
            print(f"  coalesced {st['pairs']} pairs into {st['batches']} "
                  f"dispatches (mean fill {st['mean_fill']:.1f}, max "
                  f"{st['max_fill']}); rejected={st['rejected']} "
                  f"expired={st['expired']}")
            print(f"  writer session: ticket {ticket} -> "
                  f"spc({a},{b})=({d},{c}) read its own write "
                  f"(v{service.ticket_version(ticket)})")


if __name__ == "__main__":
    main()
