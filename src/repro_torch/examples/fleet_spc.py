"""Multi-host serving fleet: one updater process, one puller replica.

The DSPC fleet story end to end, across two REAL processes sharing
nothing but a publication directory (``repro_torch.serve.transport``'s
``DirTransport``: committed ``step_*`` dirs + ``LATEST`` pointer):

* the **updater** process owns the graph, applies a deterministic edge-
  event stream chunk by chunk, and publishes every committed version;
* the **replica** process (this one) runs ``SPCService(role="replica")``
  -- a puller thread follows the directory, verifies each version, and
  swaps it into the local store; readers pin per batch exactly as on
  the updater host.  Every served batch is checked against the
  ``bfs_spc`` oracle on the graph *at the version the batch pinned*
  (both processes derive the stream from the same seed, and one
  committed chunk == one version, so version k <-> first k chunks).

Then the fleet part:

1. **Kill the updater** (SIGKILL, mid-stream).  The replica keeps
   serving its last pulled version -- queries stay oracle-correct, the
   version stays frozen, no reader ever sees an error.
2. **Restart it behind** (fresh state, ``--resume`` omitted).  The
   publisher gets the typed ``PublisherBehindError`` at attach and
   dies; the fleet is never rolled back.
3. **Restart it correctly** (``--resume``: rebuild the graph at the
   committed ``LATEST``, adopt that version, re-attach).  The re-attach
   publish of the committed version is an idempotent no-op; the stream
   continues and the replica catches up to the final version.

Both processes run on ``--device`` (default ``cuda``); the replica
spawns the updater as ``python -m repro_torch.examples.fleet_spc --role
updater``.

Run:  python -m repro_torch.examples.fleet_spc [--transport socket]
      python -m repro_torch.examples.fleet_spc --fast   # CI smoke
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import refimpl as R
from repro_torch.core.graph import INF
from repro_torch.data import graph_stream, random_graph_edges

SEED = 7


def stream_chunks(args):
    """The deterministic event stream both processes derive: version k
    on the wire <-> ``chunks[:k]`` applied to the base graph."""
    edges = random_graph_edges(args.n, args.m, seed=SEED)
    events = graph_stream(edges, args.n, args.chunks * args.chunk_size,
                          args.chunks * args.chunk_size // 3,
                          seed=SEED + 1)
    chunks = [events[k * args.chunk_size:(k + 1) * args.chunk_size]
              for k in range(args.chunks)]
    return edges, [ch for ch in chunks if ch]


def edge_set_at(edges, chunks, version):
    """Host-side replay: the exact edge set version ``version`` serves."""
    present = {tuple(sorted(e)) for e in edges}
    for ch in chunks[:version]:
        for op, a, b in ch:
            (present.add if op == "+" else present.discard)(
                tuple(sorted((a, b))))
    return present


# -- the updater process ----------------------------------------------------
def run_updater(args):
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.serve import SPCService
    from repro_torch.serve.transport import PublisherBehindError
    from repro_torch.train import checkpoint as C

    edges, chunks = stream_chunks(args)
    start = 0
    if args.resume:
        start = C.latest_step(args.dir) or 0
        print(f"[updater] resuming behind LATEST=v{start}: replaying "
              f"{start} chunk(s) host-side", flush=True)
        spc = DynamicSPC(args.n, sorted(edge_set_at(edges, chunks, start)),
                         l_cap=args.l_cap, device=args.device)
        spc.version = start  # adopt the committed stream position
    else:
        spc = DynamicSPC(args.n, edges, l_cap=args.l_cap,
                         device=args.device)
    try:
        service = SPCService(spc=spc, transport=args.transport,
                             publish_dir=args.dir,
                             update_batch=args.chunk_size)
    except PublisherBehindError as e:
        # a restarted updater that lost state: typed, on THIS side
        print(f"[updater] refusing to publish: {e}", flush=True)
        sys.exit(3)
    with service:
        print(f"[updater] publishing v{start}..v{len(chunks)} over "
              f"{args.transport!r} at {args.dir}", flush=True)
        for k in range(start, len(chunks)):
            service.submit(chunks[k])
            service.drain()
            assert service.version == k + 1, (service.version, k)
            print(f"[updater] published v{service.version}", flush=True)
            time.sleep(args.pulse)  # the window the kill phase aims at
    print("[updater] stream complete", flush=True)


# -- the replica process (the orchestrator) ---------------------------------
def spawn_updater(args, *, resume=False):
    cmd = [sys.executable, "-m", "repro_torch.examples.fleet_spc",
           "--role", "updater",
           "--dir", args.dir, "--transport", args.transport,
           "--n", str(args.n), "--m", str(args.m),
           "--chunks", str(args.chunks),
           "--chunk-size", str(args.chunk_size),
           "--l-cap", str(args.l_cap), "--pulse", str(args.pulse),
           "--device", args.device]
    if resume:
        cmd.append("--resume")
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(cmd, env=env)


class OracleChecker:
    """bfs_spc ground truth per (version, source), cached -- both
    processes derive the same stream, so the replica can reconstruct
    the graph any pinned version serves."""

    def __init__(self, args):
        self.edges, self.chunks = stream_chunks(args)
        self.n = args.n
        self._cache = {}

    def check(self, version, s, t, d, c):
        for k, (sk, tk) in enumerate(zip(s, t)):
            key = (version, int(sk))
            if key not in self._cache:
                g = R.RefGraph(self.n, sorted(
                    edge_set_at(self.edges, self.chunks, version)))
                self._cache[key] = R.bfs_spc(g, int(sk))
            dist, cnt = self._cache[key]
            tk = int(tk)
            if dist[tk] >= int(INF):
                assert int(c[k]) == 0 and int(d[k]) >= int(INF), \
                    f"v{version} spc({sk},{tk})"
            else:
                assert (int(d[k]), int(c[k])) == \
                    (int(dist[tk]), int(cnt[tk])), \
                    f"v{version} spc({sk},{tk}): got ({int(d[k])}," \
                    f"{int(c[k])}) want ({int(dist[tk])},{int(cnt[tk])})"


def serve_checked(serve, oracle, rng, args, batches=1):
    """Serve ``batches`` pinned batches, each oracle-checked at the
    exact version it pinned."""
    for _ in range(batches):
        s = rng.integers(0, args.n, args.query_batch)
        t = rng.integers(0, args.n, args.query_batch)
        d, c = serve(s, t)
        oracle.check(serve.last_version, s, t, d.cpu().numpy(),
                     c.cpu().numpy())
    return serve.last_version


def run_replica(args):
    from repro_torch.serve import SPCService

    oracle = OracleChecker(args)
    total = len(oracle.chunks)
    rng = np.random.default_rng(2)
    updater = spawn_updater(args)
    print(f"[replica] updater pid {updater.pid}; pulling {args.transport!r}"
          f" from {args.dir}", flush=True)
    replica = SPCService(role="replica", transport=args.transport,
                         publish_dir=args.dir,
                         poll_interval_s=args.poll_interval_s,
                         wait_timeout=600.0, device=args.device)
    queries = 0
    try:
        t0 = time.perf_counter()
        with replica:
            print(f"[replica] first pull after "
                  f"{time.perf_counter() - t0:.1f}s: serving v"
                  f"{replica.version}", flush=True)
            serve = replica.reader()
            serve_checked(serve, oracle, rng, args)  # warm + check v0+

            # -- phase 1: serve oracle-checked batches while the stream
            # advances underneath, until the kill point is pulled ------
            seen = set()
            while replica.version < args.kill_after:
                v = serve_checked(serve, oracle, rng, args)
                queries += args.query_batch
                if v not in seen:
                    seen.add(v)
                    print(f"[replica] serving v{v} (oracle OK)",
                          flush=True)
                time.sleep(args.poll_interval_s)

            # -- phase 2: kill the updater mid-stream ------------------
            updater.kill()
            updater.wait()
            print(f"[replica] KILLED updater at local v{replica.version}",
                  flush=True)
            replica.drain()          # catch up to whatever it committed
            frozen = replica.version
            for _ in range(2):       # sample the dead window twice
                v = serve_checked(serve, oracle, rng, args, batches=2)
                queries += 2 * args.query_batch
                assert v == frozen == replica.version, (v, frozen)
                time.sleep(2 * args.poll_interval_s)
            st = replica.stats()["replica"]
            print(f"[replica] updater dead, still serving v{frozen} "
                  f"(oracle OK; pulls={st['pulls']} errors={st['errors']})",
                  flush=True)

            # -- phase 3: a restart that LOST state must die typed -----
            behind = spawn_updater(args, resume=False)
            rc = behind.wait()
            assert rc == 3, f"behind updater exited {rc}, wanted typed 3"
            assert replica.version == frozen
            print("[replica] behind restart refused on the publisher "
                  "(PublisherBehindError); fleet never rolled back",
                  flush=True)

            # -- phase 4: correct restart resumes the stream -----------
            updater = spawn_updater(args, resume=True)
            while replica.version < total:
                v = serve_checked(serve, oracle, rng, args)
                queries += args.query_batch
                time.sleep(args.poll_interval_s)
            rc = updater.wait()
            assert rc == 0, f"resumed updater exited {rc}"
            replica.drain()
            assert replica.version == total, (replica.version, total)
            serve_checked(serve, oracle, rng, args, batches=2)
            queries += 2 * args.query_batch
            st = replica.stats()
            rs = st["replica"]
            print(f"[replica] caught up to final v{replica.version}; "
                  f"served {queries + args.query_batch * 3} oracle-"
                  f"checked queries across the crash "
                  f"(pulls={rs['pulls']} skipped_behind="
                  f"{rs['skipped_behind']} errors={rs['errors']})",
                  flush=True)
            print("fleet demo OK: replica stayed oracle-correct through "
                  "updater death, a behind restart, and a resumed stream",
                  flush=True)
    finally:
        if updater.poll() is None:
            updater.kill()
            updater.wait()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="replica",
                    choices=["replica", "updater"])
    ap.add_argument("--dir", default=None,
                    help="publication directory (default: a tempdir)")
    ap.add_argument("--transport", default="dir",
                    choices=["dir", "socket"])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--m", type=int, default=600)
    ap.add_argument("--l-cap", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=8,
                    help="committed chunks == published versions")
    ap.add_argument("--chunk-size", type=int, default=6)
    ap.add_argument("--kill-after", type=int, default=3,
                    help="kill the updater once this version is pulled")
    ap.add_argument("--pulse", type=float, default=0.5,
                    help="updater sleep between chunks (the kill window)")
    ap.add_argument("--poll-interval-s", type=float, default=0.05)
    ap.add_argument("--query-batch", type=int, default=32)
    ap.add_argument("--resume", action="store_true",
                    help="(updater) rebuild at the committed LATEST and "
                         "continue the stream")
    ap.add_argument("--fast", action="store_true",
                    help="tiny sizes for the CI examples smoke step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.n, args.m = 48, 120
        args.chunks, args.chunk_size = 5, 4
        args.kill_after, args.pulse = 2, 0.3
        args.query_batch = 16
    if args.role == "updater":
        assert args.dir, "--role updater needs --dir"
        run_updater(args)
        return
    if args.dir is None:
        with tempfile.TemporaryDirectory(prefix="fleet_spc_") as d:
            args.dir = d
            run_replica(args)
    else:
        run_replica(args)


if __name__ == "__main__":
    main()
