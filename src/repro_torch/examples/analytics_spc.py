"""Analytics served from the dynamic SPC index, end to end.

Three workloads off ONE live ``SPCService``, all via the pinned-snapshot
analytics layer (``service.analytics()`` -> ``repro_torch.analytics``):

1. **Maintained top-k betweenness** -- a ``TopKBetweenness`` view tracks
   pair-dependency scores across a mixed insert/delete stream; after
   each applied chunk ``refresh()`` diffs the published snapshots and
   re-scores only the update-affected rows (falling back to a full
   recompute when too much changed).  The counters show how many
   refreshes stayed incremental.

2. **Shortest-cycle counting** -- for the top-betweenness vertex, count
   shortest cycles through it (triangles / 4-cycles, or a certified
   girth-through-v bound) straight from the label index.

3. **Recommendation -> GNN** -- the paper's motivating application:
   friends-of-friends ranked by common-friend count (= sigma(u, x) at
   distance 2, one ``one_to_all`` dispatch).  The per-candidate SPC
   feature rows then feed the repo's model stack: a PNA forward pass
   over the ego subgraph plus an ``embedding_bag`` pooling of each
   candidate's actual common-friend ids -- the first "model consumes
   the dynamic index" scenario.

   The PNA weights and the embedding table come from seeded
   ``torch.Generator``s, so the re-rank scores are not the reference's
   (``jax.random``); every other answer is.

Run:  python -m repro_torch.examples.analytics_spc [--n 200 --m 600]
      python -m repro_torch.examples.analytics_spc --fast  # CI smoke
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.analytics import neighbors
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.gnn import from_numpy
from repro_torch.models.gnn.pna import PNA, PNAConfig
from repro_torch.serve import SPCService


def ego_batch(view, u, candidates, d_in, device):
    """Padded GraphBatch over {u} + N(u) + candidates, features from
    the pinned snapshot only."""
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--m", type=int, default=600)
    ap.add_argument("--inserts", type=int, default=12)
    ap.add_argument("--deletes", type=int, default=4)
    ap.add_argument("--update-batch", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--fast", action="store_true",
                    help="tiny sizes for the CI examples smoke step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.n, args.m = 80, 240
        args.inserts, args.deletes = 6, 2
        args.pairs = 96

    edges = random_graph_edges(args.n, args.m, seed=0)
    print(f"building service: n={args.n} m={len(edges)}")
    t0 = time.perf_counter()
    service = SPCService(args.n, edges, l_cap=32,
                         update_batch=args.update_batch, device=args.device)
    print(f"  built in {time.perf_counter() - t0:.2f}s")
    events = graph_stream(edges, args.n, args.inserts, args.deletes, seed=1)

    with service:
        ana = service.analytics(top_k=args.k)

        # -- 1. maintained top-k betweenness over the update stream ------
        pairs = ana.sample_pairs(args.pairs)
        maint = ana.betweenness_maintainer(pairs)
        print(f"maintainer: v{maint.version:02d}, {args.pairs} pairs, "
              f"top-{args.k} seeded")
        t0 = time.perf_counter()
        for lo in range(0, len(events), args.update_batch):
            service.submit(events[lo:lo + args.update_batch])
            service.drain()
            maint.refresh()
            changed = maint.last_changed
            top_v, top_s = maint.top(1)[0]
            print(f"  v{maint.version:02d} | {changed:3d} rows changed | "
                  f"top bc: vertex {top_v} ({top_s:.1f})")
        elapsed = time.perf_counter() - t0
        print(f"replayed {len(events)} events in {elapsed:.2f}s: "
              f"{maint.incremental_refreshes} incremental refreshes, "
              f"{maint.full_recomputes} full recomputes")
        print(f"top-{args.k}: "
              + ", ".join(f"{v}:{s:.1f}" for v, s in maint.top(args.k)))

        # -- 2. shortest cycles through the hottest vertex ---------------
        view = ana.pin()                  # ONE snapshot for what follows
        hot = maint.top(1)[0][0]
        cyc = view.cycles_through_vertex(hot)
        if cyc.certified:
            print(f"shortest cycle through {hot}: length {cyc.length} "
                  f"x{cyc.count} ({cyc.odd_count} triangles, "
                  f"{cyc.even_count} 4-cycles)")
        else:
            print(f"shortest cycle through {hot}: girth > {cyc.horizon} "
                  f"(beyond the index's certified horizon)")

        # -- 3. recommendation features -> PNA + embedding_bag -----------
        sizes = view.index.size[:view.n].cpu().numpy()
        u = int(np.argmax(sizes))         # a well-covered user
        recs = view.recommend(u)
        if not recs:
            print(f"user {u}: no friends-of-friends to recommend")
            return
        cand = np.asarray([r.vertex for r in recs])
        print(f"user {u}: {len(cand)} candidates by common-friend count: "
              + ", ".join(f"{r.vertex}(x{r.score})" for r in recs))

        dev = view.index.device
        cfg = PNAConfig(n_layers=2, d_hidden=16, d_in=4, n_out=1)
        batch, sub, local = ego_batch(view, u, cand, cfg.d_in, dev)
        pna = PNA(cfg, generator=torch.Generator().manual_seed(0),
                  device=dev)
        with torch.no_grad():
            node_scores = pna(batch)[:, 0].cpu().numpy()

        # pool each candidate's common-friend ids through an embedding
        # table (pad to one static width; pad ids contribute zero)
        ids = [view.common_neighbor_ids(u, int(x)) for x in cand]
        width = max(max(len(i) for i in ids), 1)
        padded = np.full((len(cand), width), view.n, dtype=np.int32)
        for row, i in zip(padded, ids):
            row[:len(i)] = i
        table = torch.randn((view.n, 8), generator=torch.Generator()
                            .manual_seed(1)).to(dev)
        pooled = embedding_bag(torch.from_numpy(padded).to(dev), table,
                               mode="mean", pad_id=view.n)
        model = (node_scores[[local[int(x)] for x in cand]]
                 + pooled.mean(dim=1).cpu().numpy())
        order = np.argsort(-model)
        print(f"model re-rank (PNA over {len(sub)}-node ego net + pooled "
              f"common-friend embeddings): "
              + ", ".join(f"{int(cand[i])}({model[i]:+.2f})"
                          for i in order))
        print(f"all answers from pinned snapshot v{view.version}")


if __name__ == "__main__":
    main()
