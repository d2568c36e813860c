"""HybSPC: the mixed insert/delete batch engine.

Port of ``repro.core.hybrid``.  Events are an int32 [B, 3] array of
``(op, a, b)`` rows, replayed strictly in stream order (so the ESPC
invariant holds after every prefix):

* ``op == OP_INSERT`` (1): IncSPC;
* ``op == OP_DELETE`` (2): DecSPC with the isolated-vertex fast path;
* rows with ``a == b``, and unknown ops, are no-ops (padding).

The reference runs the chunk as one ``lax.scan`` with a ``lax.switch``
per row.  Here the events live on the host, so the branch is a Python
``if`` on the host array and costs no device sync.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bfs import RelaxFn
from repro_torch.core.decremental import dec_spc_step
from repro_torch.core.graph import Graph
from repro_torch.core.incremental import inc_spc
from repro_torch.core.labels import SPCIndex

OP_INSERT = 1
OP_DELETE = 2


def hyb_spc_batch(g: Graph, idx: SPCIndex, events,
                  relax_fn: RelaxFn | None = None) -> tuple[Graph, SPCIndex]:
    """Apply a tagged ``(op, a, b)`` [B, 3] event array in stream order.

    The caller guarantees edge capacity for every insertion and a valid
    stream (``repro_torch.core.dynamic.DynamicSPC.apply_events``
    validates it host-side).  Label overflow anywhere in the batch
    accumulates in the returned index's ``overflow`` counter.
    """
    rows = np.asarray(events, dtype=np.int64).reshape(-1, 3).tolist()
    for op, a, b in rows:
        if a == b:
            continue
        if op == OP_INSERT:
            g, idx = inc_spc(g, idx, a, b, relax_fn)
        elif op == OP_DELETE:
            g, idx = dec_spc_step(g, idx, a, b, relax_fn)
    return g, idx
