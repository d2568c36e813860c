"""Streaming-update service demo (the paper's Section 4.4 scenario),
consumed through the ``SPCService`` façade.

The service ingests a mixed stream of edge insertions and deletions on
a power-law graph through the async queue -- each submitted chunk
replays as one ``apply_events`` dispatch (``hyb_spc_batch``) on the
updater thread -- while shortest-path-counting queries are answered
between chunks through a pinned reader.  ``drain()`` makes the ingest
synchronous where the demo wants lockstep timing; state is
checkpointed and restored mid-stream (``SPCService.from_state_dict``)
to demonstrate fault tolerance.

Run:  python -m repro_torch.examples.dynamic_stream [--n 200 --m 600]
      python -m repro_torch.examples.dynamic_stream --fast  # CI smoke
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core.graph import INF
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.serve import SPCService
from repro_torch.train import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--m", type=int, default=600)
    ap.add_argument("--inserts", type=int, default=12)
    ap.add_argument("--deletes", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8,
                    help="events per dispatch (hyb_spc_batch)")
    ap.add_argument("--fast", action="store_true",
                    help="tiny sizes for the CI examples smoke step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.n, args.m = 60, 150
        args.inserts, args.deletes = 4, 2

    edges = random_graph_edges(args.n, args.m, seed=0)
    print(f"building service: n={args.n} m={len(edges)}")
    t0 = time.perf_counter()
    service = SPCService(args.n, edges, l_cap=32,
                         update_batch=max(1, args.batch), device=args.device)
    print(f"  built in {time.perf_counter() - t0:.2f}s, "
          f"{service.spc.index_entries()} entries")

    events = graph_stream(edges, args.n, args.inserts, args.deletes, seed=1)
    rng = np.random.default_rng(2)
    acc = 0.0
    step = max(1, args.batch)
    with service:
        for lo in range(0, len(events), step):
            chunk = events[lo:lo + step]
            t0 = time.perf_counter()
            service.submit(chunk)
            service.drain()              # lockstep: wait out this chunk
            acc += time.perf_counter() - t0
            s, t = rng.integers(0, args.n, 2)
            d, c = service.query_pair(int(s), int(t))
            d = "inf" if d >= int(INF) else d
            ops = "".join(op for op, _, _ in chunk)
            print(f"  events[{lo:3d}:{lo + len(chunk):3d}] [{ops}] "
                  f"in 1 dispatch  query spc({s},{t}) = ({d}, {c})  "
                  f"acc={acc:.2f}s v{service.version}")

        with tempfile.TemporaryDirectory() as tmp:
            print("checkpointing service state ...")
            ckpt.save(tmp, 0, service.state_dict())
            state, _, _ = ckpt.restore(tmp, service.state_dict(),
                                       device="cpu")
            replica = SPCService.from_state_dict(
                service.spc.n, {k: v.numpy() for k, v in state.items()},
                device=args.device)
            s, t = 0, args.n - 1
            assert replica.query_pair(s, t) == service.query_pair(s, t)
            replica.close()
            print("  restored replica answers identically: OK")

        stats = service.stats()
        update = stats["update"]
        print(f"stream done: {update}")
        if update.batches:
            print(f"  {len(events)} events in {update.batches} "
                  f"dispatches ({update.events_per_batch:.1f} "
                  f"events/dispatch) across {stats['publishes']} "
                  f"published versions")


if __name__ == "__main__":
    main()
