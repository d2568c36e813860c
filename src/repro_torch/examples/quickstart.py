"""Quickstart: the paper's worked example, end to end.

Builds the SPC-Index of Figure 2, answers the Example 2.1 query, applies
the Figure 3 insertion and the Figure 6 deletion with IncSPC / DecSPC,
and cross-checks every answer against online BFS counting (the
paper-faithful ``core.refimpl``); ``main`` returns whether every answer
agreed.

Run:  python -m repro_torch.examples.quickstart [--device cuda]
"""

import argparse

from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import INF
from repro_torch.core.refimpl import RefGraph, bfs_spc

PAPER_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 8), (0, 11),
    (1, 2), (1, 5), (1, 6),
    (2, 3), (2, 5),
    (3, 7), (3, 8),
    (4, 5), (4, 7), (4, 9),
    (6, 10), (9, 10),
]


def oracle(edges, n, s, t):
    dist, cnt = bfs_spc(RefGraph(n, edges), s)
    d = int(dist[t])
    return (d if d < int(INF) else None, int(cnt[t]))


def show(svc, edges, s, t, label):
    d, c = svc.query(s, t)
    d = None if d >= int(INF) else d
    od, oc = oracle(edges, svc.n, s, t)
    flag = "OK" if (d, c) == (od, oc) else "MISMATCH"
    print(f"  [{flag}] {label}: spc(v{s}, v{t}) = dist {d}, count {c}")
    return flag == "OK"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== building SPC-Index of the paper's Figure-2 graph ==")
    svc = DynamicSPC(12, PAPER_EDGES, l_cap=8, device=args.device)
    print(f"  index entries: {svc.index_entries()} "
          f"({svc.index_bytes()} bytes packed)")
    edges = list(PAPER_EDGES)
    ok = [show(svc, edges, 4, 6, "Example 2.1"),
          show(svc, edges, 0, 9, "long pair")]

    print("== IncSPC: insert (v3, v9)  [Figure 3] ==")
    svc.insert_edge(3, 9)
    edges.append((3, 9))
    ok += [show(svc, edges, 0, 9, "post-insert"),
           show(svc, edges, 4, 6, "unaffected pair")]

    print("== DecSPC: delete (v1, v2)  [Figure 6] ==")
    svc.delete_edge(1, 2)
    edges.remove((1, 2))
    ok += [show(svc, edges, 1, 2, "post-delete"),
           show(svc, edges, 0, 9, "unchanged pair")]

    print("== vertex events ==")
    v = svc.insert_vertex()
    svc.insert_edge(v, 0)
    edges.append((v, 0))
    ok.append(show(svc, edges, v, 9, f"new vertex v{v}"))
    print("done.")
    return all(ok)


if __name__ == "__main__":
    main()
