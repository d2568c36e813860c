"""Dynamic SPC-Index maintenance in PyTorch (port of ``repro.core``).

Layers (bottom-up):

* ``graph``       -- fixed-capacity dynamic edge-list graph.
* ``labels``      -- the SPC-Index as padded label matrices + bulk ops.
* ``query``       -- Algorithm 1 (pair queries) and dense one-vs-all.
* ``bfs``         -- level-synchronous counting BFS.
* ``order``       -- vertex orderings applied at the id boundary.
* ``construct``   -- HP-SPC construction, sequential and batched.
* ``incremental`` -- IncSPC (Algorithms 2-3) + batched insertion.
* ``decremental`` -- DecSPC (Algorithms 4-6) + batched deletion.
* ``hybrid``      -- mixed insert/delete event chunks.
* ``dynamic``     -- the host-side driver (capacity, events, state).
* ``directed``    -- the directed extension (Appendix C.1), pure Python.
* ``distributed`` -- one controller over a device mesh: the
  edge-sharded relaxation bound into the shared build / update bodies
  (``make_distributed_builder``, ``make_distributed_updater``), index
  replicas and batch-sharded queries.
"""

from repro_torch.core.bfs import plain_spc_bfs, pruned_spc_bfs
from repro_torch.core.construct import build_index, build_index_batched
from repro_torch.core.decremental import dec_spc, dec_spc_batch, srr_search
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import INF, Graph, from_edges, graph_from_numpy
from repro_torch.core.hybrid import OP_DELETE, OP_INSERT, hyb_spc_batch
from repro_torch.core.incremental import inc_spc, inc_spc_batch
from repro_torch.core.labels import SPCIndex, empty_index, index_from_numpy
from repro_torch.core.query import (batched_query, batched_query_merge,
                                    gather_rows, merge_rows, one_to_all,
                                    pair_query, pre_pair_query)

__all__ = [
    "Graph", "from_edges", "graph_from_numpy", "INF",
    "SPCIndex", "empty_index", "index_from_numpy",
    "pair_query", "pre_pair_query", "batched_query", "batched_query_merge",
    "gather_rows", "merge_rows", "one_to_all",
    "plain_spc_bfs", "pruned_spc_bfs",
    "build_index", "build_index_batched", "inc_spc", "inc_spc_batch",
    "dec_spc", "dec_spc_batch", "srr_search",
    "hyb_spc_batch", "OP_INSERT", "OP_DELETE",
    "DynamicSPC",
]
