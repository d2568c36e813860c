"""Fixed-shape padded graph batches (the GNN substrate's data format).

Port of ``repro.models.gnn.graph``.  One extra "dump" node row absorbs
padded edges:

* node arrays have ``n_node + 1`` rows; row ``n_node`` is the dump row;
* padded edge slots point at ``(n_node, n_node)``;
* ``graph_id`` maps node -> graph, the dump row -> ``n_graph``.

The segment aggregations are plain torch segment ops (``index_add_``,
``scatter_reduce_``), as the reference's are plain XLA ops.
``jax.ops.segment_max`` / ``segment_min`` give -inf / +inf on an empty
segment; the outputs here start at those values so empty segments
match.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.func

from repro_torch.core.graph import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    nodes: torch.Tensor            # f[N + 1, F] node features (dump row 0)
    senders: torch.Tensor          # int64[E] (pad = N)
    receivers: torch.Tensor        # int64[E] (pad = N)
    pos: Optional[torch.Tensor]    # f[N + 1, 3] positions or None
    graph_id: torch.Tensor         # int64[N + 1] (dump row = G)
    n_node: int
    n_graph: int

    @property
    def n_edge(self) -> int:
        return self.senders.shape[0]

    @property
    def node_mask(self) -> torch.Tensor:
        return torch.arange(self.n_node + 1,
                            device=self.nodes.device) < self.n_node

    @property
    def edge_mask(self) -> torch.Tensor:
        return self.senders != self.n_node


def batch_spec(n_node: int, n_edge: int, d_feat: int, *, with_pos: bool,
               n_graph: int = 1, dtype=torch.float32) -> GraphBatch:
    """The abstract ``GraphBatch`` of ``src/repro/models/gnn/graph.py:47``:
    its leaves are tensors on the meta device, of the shapes the
    reference's are; the index leaves are int64 where the reference's
    are int32 (the port's segment ops index with int64, as
    :func:`from_numpy` makes them)."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return GraphBatch(
        nodes=meta((n_node + 1, d_feat), dtype),
        senders=meta((n_edge,), torch.int64),
        receivers=meta((n_edge,), torch.int64),
        pos=meta((n_node + 1, 3), dtype) if with_pos else None,
        graph_id=meta((n_node + 1,), torch.int64),
        n_node=n_node, n_graph=n_graph)


def from_numpy(node_feat: np.ndarray, senders: np.ndarray,
               receivers: np.ndarray, *, pos: np.ndarray | None = None,
               graph_id: np.ndarray | None = None, n_graph: int = 1,
               e_cap: int | None = None, device="cuda") -> GraphBatch:
    """Host-side constructor with dump-row padding, placed on
    ``device``."""
    dev = resolve_device(device)
    n, f = node_feat.shape
    e = len(senders)
    e_cap = e_cap or e
    if e > e_cap:
        raise ValueError(f"{e} edges exceed e_cap={e_cap}")
    nodes = np.zeros((n + 1, f), node_feat.dtype)
    nodes[:n] = node_feat
    s = np.full(e_cap, n, dtype=np.int64)
    r = np.full(e_cap, n, dtype=np.int64)
    s[:e] = senders
    r[:e] = receivers
    gid = np.full(n + 1, n_graph, dtype=np.int64)
    gid[:n] = graph_id if graph_id is not None else 0
    p = None
    if pos is not None:
        p = np.zeros((n + 1, 3), pos.dtype)
        p[:n] = pos
        p = torch.from_numpy(p).to(dev)
    return GraphBatch(
        nodes=torch.from_numpy(nodes).to(dev), senders=torch.from_numpy(s).to(dev),
        receivers=torch.from_numpy(r).to(dev), pos=p,
        graph_id=torch.from_numpy(gid).to(dev), n_node=n, n_graph=n_graph)


# -------------------------------------------------------------------------
# Segment aggregations over edges -> nodes.  Each takes per-edge values
# [E, ...] and receivers [E]; the dump row makes padded edges harmless.
# -------------------------------------------------------------------------
def agg_sum(msgs, receivers, n_rows):
    out = msgs.new_zeros((n_rows,) + tuple(msgs.shape[1:]))
    return out.index_add_(0, receivers, msgs)


def degrees(receivers, n_rows, dtype=torch.float32):
    ones = torch.ones(receivers.shape[0], dtype=dtype,
                      device=receivers.device)
    return agg_sum(ones, receivers, n_rows)


def agg_mean(msgs, receivers, n_rows, eps=1e-9):
    tot = agg_sum(msgs, receivers, n_rows)
    deg = degrees(receivers, n_rows, msgs.dtype)
    return tot / (deg[:, None] + eps), deg


def _agg_extreme(msgs, receivers, n_rows, reduce, start):
    out = msgs.new_full((n_rows,) + tuple(msgs.shape[1:]), start)
    index = receivers.reshape((-1,) + (1,) * (msgs.dim() - 1))
    return out.scatter_reduce_(0, index.expand_as(msgs), msgs, reduce)


def agg_max(msgs, receivers, n_rows):
    return _agg_extreme(msgs, receivers, n_rows, "amax", -float("inf"))


def agg_min(msgs, receivers, n_rows):
    return _agg_extreme(msgs, receivers, n_rows, "amin", float("inf"))


def agg_std(msgs, receivers, n_rows, eps=1e-9):
    mean, deg = agg_mean(msgs, receivers, n_rows, eps)
    sq, _ = agg_mean(msgs * msgs, receivers, n_rows, eps)
    var = torch.clamp(sq - mean * mean, min=0.0)
    return torch.sqrt(var + eps), mean, deg


def graph_readout(node_vals, graph_id, n_graph, op: str = "sum"):
    """Per-graph readout (molecule batches); drops the dump graph."""
    if op == "sum":
        out = agg_sum(node_vals, graph_id, n_graph + 1)
    elif op == "mean":
        tot = agg_sum(node_vals, graph_id, n_graph + 1)
        cnt = degrees(graph_id, n_graph + 1, node_vals.dtype)
        out = tot / torch.clamp(cnt[:, None], min=1.0)
    else:
        raise ValueError(op)
    return out[:n_graph]


def replicated_specs(model) -> dict:
    """``()`` (replicated) for every leaf of ``model``'s own parameter
    tree, ``dict(model.named_parameters())`` -- the tree the GNNs'
    losses and the training loop take.  The reference's GNN
    ``param_specs`` build theirs from a one-layer tiny config, which
    matches no parameter tree of more than one layer; its callers
    replicate the parameters instead (``launch/steps.py``
    ``_replicated_like``), as these specs do."""
    return {name: () for name, _ in model.named_parameters()}


def mse_loss(model):
    """The molecule models' ``make_loss`` (``egnn.py:130``,
    ``nequip.py:187``, ``equiformer_v2.py:287`` of the reference) for
    ``model``: loss_fn(params, (batch, target)) -> the mean squared error
    of the graph outputs [G, n_out] against ``target``.

    The port's GNNs are modules, so ``params`` maps the module's
    parameter names to tensors (``dict(model.named_parameters())``, the
    tree the training loop updates); ``torch.func.functional_call`` puts
    them in the module for the call only (a swap of tensors, not a
    transform: autograd sees the tensors of ``params``)."""
    def loss_fn(params, batch_and_target):
        batch, target = batch_and_target
        g = torch.func.functional_call(model, params, (batch,))[0]
        return ((g - target) ** 2).mean()
    return loss_fn
