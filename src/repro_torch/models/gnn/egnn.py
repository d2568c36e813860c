"""EGNN: E(n)-equivariant graph network [Satorras et al., arXiv:2102.09844].

Port of ``repro.models.gnn.egnn``.  Messages depend on invariants
(h_i, h_j, ||x_i - x_j||^2); coordinates update along relative vectors:

    m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
    x_i' = x_i + C * sum_j (x_i - x_j) * phi_x(m_ij)
    h_i' = h_i + phi_h(h_i, sum_j m_ij)

with C = 1 / (deg_i + 1) when ``coord_agg_mean``.  The aggregations are
the port's ``agg_sum`` (``index_add_``), as the reference's are
``jax.ops.segment_sum``.  Each edge shard (``graph.EdgeShards``: one on
one device) computes its messages with its own ``phi_e`` / ``phi_x``
and its partial ``dx``, degrees and ``magg``; the shards' sums are
added before the division by ``deg + 1`` and the node update, which
runs once.

Weights are held in the reference's ``[in, out]`` layout (``x @ w + b``),
so :meth:`EGNN.load_reference_params` copies them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import MLP
from repro_torch.models.gnn.graph import (EdgeShards, GraphBatch, agg_sum,
                                          graph_readout, mse_loss,
                                          replicated_specs)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_out: int = 1                   # graph-level targets (energy)
    coord_agg_mean: bool = True      # C = 1/(deg + 1) (large graphs)
    dtype: Any = torch.float32


class EGNNLayer(nn.Module):
    def __init__(self, cfg: EGNNConfig, generator, device) -> None:
        super().__init__()
        h = cfg.d_hidden
        kw = dict(generator=generator, dtype=cfg.dtype, device=device)
        self.coord_agg_mean = cfg.coord_agg_mean
        self.phi_e = MLP([2 * h + 1, h, h], **kw)
        self.phi_x = MLP([h, h, 1], **kw)
        self.phi_h = MLP([2 * h, h, h], **kw)

    #: The submodules each edge shard runs with its own parameters.
    EDGE = ("phi_e", "phi_x")

    def edge_sums(self, shard, h, x, n_node: int):
        """One edge shard's partial sums: (dx, degrees or None, magg),
        each [N + 1, ...]."""
        s, r = shard.senders, shard.receivers
        n1 = n_node + 1
        mask = s != n_node
        rel = x[r] - x[s]                                 # x_i - x_j at recv i
        d2 = (rel * rel).sum(dim=-1, keepdim=True)
        m = self.phi_e(torch.cat([h[r], h[s], d2], dim=-1), last_act=True)
        m = m * mask[:, None].to(m.dtype)                 # [E, h]
        dx = agg_sum(rel * self.phi_x(m), r, n1)
        deg = agg_sum(mask.to(x.dtype), r, n1) if self.coord_agg_mean \
            else None
        return dx, deg, agg_sum(m, r, n1)

    def forward(self, h, x, batch: GraphBatch, edges: EdgeShards):
        parts = [sh.call(self, self.EDGE, EGNNLayer.edge_sums, sh, hd, xd,
                         batch.n_node)
                 for sh, hd, xd in zip(edges, edges.on_shards(h),
                                       edges.on_shards(x))]
        # coordinate update
        dx = edges.sum([p[0] for p in parts])
        if self.coord_agg_mean:
            dx = dx / (edges.sum([p[1] for p in parts])[:, None] + 1.0)
        x = x + dx
        # feature update
        magg = edges.sum([p[2] for p in parts])
        h = h + self.phi_h(torch.cat([h, magg], dim=-1))
        return h, x


class EGNN(nn.Module):
    """embed -> ``n_layers`` EGNN layers -> head.  Weights come from
    ``generator`` (default: a CPU generator seeded 0) unless carried
    across with :meth:`load_reference_params`."""

    def __init__(self, cfg: EGNNConfig, *, generator=None,
                 device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(generator=generator, dtype=cfg.dtype, device=dev)
        self.cfg = cfg
        self.embed = MLP([cfg.d_in, cfg.d_hidden], **kw)
        self.layers = nn.ModuleList(
            EGNNLayer(cfg, generator, dev) for _ in range(cfg.n_layers))
        self.head = MLP([cfg.d_hidden, cfg.d_hidden, cfg.n_out], **kw)

    def _trunk(self, batch: GraphBatch, edges: EdgeShards | None):
        edges = EdgeShards.whole(batch) if edges is None else edges
        h = self.embed(batch.nodes.to(self.cfg.dtype))
        x = batch.pos.to(self.cfg.dtype)
        for layer in self.layers:
            h, x = layer(h, x, batch, edges)
        return h, x

    def forward(self, batch: GraphBatch, edges: EdgeShards | None = None):
        """Returns (graph_out [G, n_out], h [N+1, d], x [N+1, 3]);
        ``edges`` (default: the batch's own, one shard) as
        ``graph.EdgeShards`` gives them."""
        h, x = self._trunk(batch, edges)
        node_out = self.head(h)
        node_out = node_out * batch.node_mask[:, None].to(node_out.dtype)
        g = graph_readout(node_out, batch.graph_id, batch.n_graph, "sum")
        return g, h, x

    def node_forward(self, batch: GraphBatch,
                     edges: EdgeShards | None = None) -> torch.Tensor:
        """Node-level logits [n_node, n_out] (classification shapes)."""
        h, _ = self._trunk(batch, edges)
        return self.head(h)[:batch.n_node]

    @torch.no_grad()
    def load_reference_params(self, tree) -> "EGNN":
        """Copy the reference's parameter tree (``egnn.init_params``,
        leaves as numpy arrays) into this module."""
        if len(tree["layers"]) != len(self.layers):
            raise ValueError(f"reference has {len(tree['layers'])} layers, "
                             f"this EGNN {len(self.layers)}")
        self.embed.load(tree["embed"])
        for layer, p in zip(self.layers, tree["layers"]):
            for name in ("phi_e", "phi_x", "phi_h"):
                getattr(layer, name).load(p[name])
        self.head.load(tree["head"])
        return self


def param_specs(cfg: EGNNConfig) -> dict:
    """Replicated specs of this model's parameter tree
    (``graph.replicated_specs``), from a module built on the meta
    device."""
    return replicated_specs(EGNN(cfg, device="meta"))


def make_loss(model: EGNN):
    """The reference's ``make_loss`` (``egnn.py:130``): loss_fn(params,
    (batch, target)) -> mean squared error of ``model``'s graph outputs;
    ``params`` by parameter name (``graph.mse_loss``)."""
    return mse_loss(model)


__all__ = ["EGNN", "EGNNConfig", "EGNNLayer", "make_loss", "param_specs"]
