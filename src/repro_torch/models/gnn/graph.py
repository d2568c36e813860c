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

Edge shards (the reference's ``"edges": ("data", "model")``, with the
nodes replicated, ``sharding.py:41-42``): the models run their edge work
shard by shard over :class:`EdgeShards` and reduce the shards' partial
``[N + 1, ...]`` aggregates onto the controller's device -- sums added
in shard order in float32 (``launch.mesh.psum``), maxima and minima
element-wise -- and run their node work once on the result.  A batch on
one device is one shard (:meth:`EdgeShards.whole`), whose reductions
return their one part as it is: the one-device path is the one-shard
case of the same code.  :meth:`EdgeShards.placed` is the edge-sharded
view of a batch laid out by ``launch.steps``' ``place_args``: mesh entry
``e``'s block of ``senders`` / ``receivers`` on its device, the
replicated node leaves as entry 0 holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.func
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import (Placed, alike, collect, psum, quiet,
                                     working)


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


def pmax(parts, device) -> torch.Tensor:
    """The element-wise max of the shards' parts on ``device`` (exact, in
    any order)."""
    return _reduce("pmax", torch.maximum, parts, device)


def pmin(parts, device) -> torch.Tensor:
    """The element-wise min of the shards' parts on ``device``."""
    return _reduce("pmin", torch.minimum, parts, device)


def _reduce(op: str, fn, parts, device) -> torch.Tensor:
    """``fn`` over the parts in order on ``device``, as a collective of a
    dry run's count (``launch.mesh.collect``)."""
    collect(op, "all-reduce", parts)
    with quiet():
        out = parts[0].to(device)
        for p in parts[1:]:
            out = fn(out, p.to(device))
        return out


class ModuleCall(nn.Module):
    """``fn(module, *args)`` as a module's forward, so that
    ``functional_call`` can swap the module's tensors in."""

    def __init__(self, module: nn.Module, fn) -> None:
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def _direct(module, names, fn, *args):
    return fn(module, *args)


def _in_work(entries, call):
    """``call`` as the work of mesh entries ``entries``
    (``launch.mesh.working``)."""
    def run(*args):
        with working(entries):
            return call(*args)
    return run


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """One shard of a batch's edges: ``senders`` / ``receivers`` (pads at
    the dump row) on ``device``, and ``call(module, names, fn, *args)``,
    which is ``fn(module, *args)`` with the parameters of ``module``'s
    submodules ``names`` this shard's own: on one device and on mesh
    entry 0 the module's; on another entry its view of them, on its
    device (``launch.steps``)."""
    device: torch.device
    senders: torch.Tensor
    receivers: torch.Tensor
    call: Callable = _direct


class EdgeShards:
    """A batch's edge shards in entry order, onto ``home`` (the
    controller's device, where the node work runs): module doc."""

    def __init__(self, shards: Sequence[EdgeShard], home,
                 stands=None) -> None:
        self.shards = tuple(shards)
        self.home = torch.device(home)
        # the entries each shard's work stands for (several in a dry run)
        self.stands = stands or [(i,) for i in range(len(self.shards))]

    @classmethod
    def whole(cls, batch: GraphBatch) -> "EdgeShards":
        """The batch's own edges as one shard."""
        dev = batch.nodes.device
        return cls([EdgeShard(dev, batch.senders, batch.receivers)], dev)

    @classmethod
    def placed(cls, batch: GraphBatch, call_of):
        """(the node part of ``batch``, its edge shards) for a batch laid
        out by ``place_args``: ``senders`` / ``receivers`` placed over the
        mesh, shard ``e`` mesh entry ``e``'s on its device; ``nodes``,
        ``pos`` and ``graph_id`` replicated, taken as entry 0 holds them
        (nothing is gathered).  ``call_of(entry, device)`` gives an
        entry's ``call`` (``None``: the module's own parameters).  The
        node part has no edges: edge work reads the shards."""
        s, r = batch.senders, batch.receivers
        if not (isinstance(s, Placed) and isinstance(r, Placed)):
            raise ValueError("an edge-sharded batch has its senders and "
                             "receivers placed (place_args)")
        devs = s.sharding.mesh.devices.flat
        shards, stands = [], []
        # shards of one shape are alike (entry 0's call is the module's
        # own): a dry run runs one for all of them (launch.mesh.alike)
        for e, same in alike([(tuple(s.shard(e).shape), e == 0)
                              for e in range(len(devs))]):
            shards.append(EdgeShard(devs[e], s.shard(e), r.shard(e),
                                    _in_work(same, call_of(e, devs[e])
                                             or _direct)))
            stands.append(same)

        def entry0(x):
            return x.shard(0) if isinstance(x, Placed) else x
        nodes = dataclasses.replace(
            batch, nodes=entry0(batch.nodes), senders=None, receivers=None,
            pos=entry0(batch.pos), graph_id=entry0(batch.graph_id))
        return nodes, cls(shards, shards[0].device, stands)

    def __iter__(self):
        return iter(self.shards)

    def on_shards(self, x: torch.Tensor) -> list:
        """``x`` on each shard's device, in shard order: itself where it
        lies, one copy on each other device (the node state for the
        shards' edge work)."""
        copies = {x.device: x}
        for sh in self.shards:
            if sh.device not in copies:
                copies[sh.device] = x.to(sh.device)
        return [copies[sh.device] for sh in self.shards]

    def _each(self, parts) -> list:
        """Each shard's part once for every entry its work stands for."""
        return [p for p, same in zip(parts, self.stands) for _ in same]

    def sum(self, parts) -> torch.Tensor:
        """The shards' partial sums added in shard order in float32 on
        ``home``, rounded once (``launch.mesh.psum``)."""
        return psum(self._each(parts), self.home)

    def max(self, parts) -> torch.Tensor:
        return pmax(self._each(parts), self.home)

    def min(self, parts) -> torch.Tensor:
        return pmin(self._each(parts), self.home)


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
