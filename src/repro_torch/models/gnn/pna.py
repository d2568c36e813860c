"""PNA: Principal Neighbourhood Aggregation [Corso et al., arXiv:2004.05718].

Port of ``repro.models.gnn.pna``.  Messages are reduced with
{mean, max, min, std} and each aggregate is rescaled by the degree
scalers {identity, amplification, attenuation}:

    s_amp(d) = log(d + 1) / delta,   s_att(d) = delta / log(d + 1)

The 4 x 3 concatenation plus the node's own state is mixed by a linear
layer (the "towers = 1" variant), with a residual SiLU update.

Each edge shard (``graph.EdgeShards``: one on one device) computes its
messages with its own ``msg`` weights and their partial sums, sums of
squares, degrees, maxima and minima; the sums are added across the
shards, the maxima and minima taken element-wise, and only then do a
row's empty max / min (-inf / +inf) become 0 -- per shard, a node whose
live messages all lie in another shard and are negative would read 0 as
its max.  The mean, std and scalers come from the summed sums, and the
node update runs once.

The reference keeps each linear layer as ``{"w": [d_in, d_out], "b"}``
and computes ``x @ w + b``; ``nn.Linear`` stores ``[d_out, d_in]``, so
:meth:`PNA.load_reference_params` transposes ``w`` on the way in.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.func
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import dense_init, softmax_cross_entropy
from repro_torch.models.gnn.graph import (EdgeShards, GraphBatch, agg_max,
                                          agg_min, agg_sum, degrees,
                                          graph_readout, replicated_specs)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_out: int = 1
    delta: float = 2.5               # avg log-degree (dataset statistic)
    node_level: bool = True          # node classification vs graph readout
    dtype: Any = torch.float32


def _linear(d_in: int, d_out: int, cfg: PNAConfig, generator, device):
    lin = nn.Linear(d_in, d_out, device=device, dtype=cfg.dtype)
    with torch.no_grad():
        lin.weight.copy_(dense_init(d_in, d_out, generator=generator,
                                    dtype=cfg.dtype, device=device).t())
        lin.bias.zero_()
    return lin


class PNALayer(nn.Module):
    def __init__(self, cfg: PNAConfig, generator, device) -> None:
        super().__init__()
        h = cfg.d_hidden
        self.delta = cfg.delta
        # message MLP on (h_i, h_j)
        self.msg = _linear(2 * h, h, cfg, generator, device)
        # post-aggregation mix: 12 aggregates + self -> h
        self.upd = _linear(13 * h, h, cfg, generator, device)

    #: The submodules each edge shard runs with its own parameters.
    EDGE = ("msg",)

    def edge_parts(self, shard, h, n_node: int):
        """One edge shard's partial aggregates [N + 1, ...]: the sums of
        its messages and of their squares, the degrees (pad slots count
        at the dump row), and the max / min over its live messages
        (-inf / +inf where it has none)."""
        s, r = shard.senders, shard.receivers
        n1 = n_node + 1
        edge_mask = (s != n_node)[:, None]
        m = F.silu(self.msg(torch.cat([h[r], h[s]], dim=-1)))
        m = m * edge_mask.to(m.dtype)
        # max/min must ignore pads: pads contribute -inf/+inf start values
        return (agg_sum(m, r, n1), agg_sum(m * m, r, n1),
                degrees(r, n1, m.dtype),
                agg_max(torch.where(edge_mask, m, -torch.inf), r, n1),
                agg_min(torch.where(edge_mask, m, torch.inf), r, n1))

    def forward(self, h: torch.Tensor, batch: GraphBatch,
                edges: EdgeShards, eps: float = 1e-9) -> torch.Tensor:
        parts = [sh.call(self, self.EDGE, PNALayer.edge_parts, sh, hd,
                         batch.n_node)
                 for sh, hd in zip(edges, edges.on_shards(h))]
        tot, sq, deg = (edges.sum([p[i] for p in parts]) for i in range(3))
        # aggregators (graph.agg_std's formulas) ---------------------------
        mean = tot / (deg[:, None] + eps)
        var = torch.clamp(sq / (deg[:, None] + eps) - mean * mean, min=0.0)
        std = torch.sqrt(var + eps)
        mx = torch.nan_to_num(edges.max([p[3] for p in parts]), neginf=0.0,
                              posinf=0.0)
        mn = torch.nan_to_num(edges.min([p[4] for p in parts]), neginf=0.0,
                              posinf=0.0)
        aggs = torch.cat([mean, mx, mn, std], dim=-1)          # [N+1, 4h]
        # scalers ----------------------------------------------------------
        logd = torch.log1p(deg)[:, None]
        amp = logd / self.delta
        att = self.delta / torch.clamp(logd, min=1e-6)
        att = torch.where(deg[:, None] > 0, att, 0.0)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)
        out = self.upd(torch.cat([h, scaled], dim=-1))
        return h + F.silu(out)


class PNA(nn.Module):
    """The PNA network: embed -> ``n_layers`` PNA layers -> head.

    Weights are drawn from ``generator`` (default: a CPU generator
    seeded 0) unless carried across with :meth:`load_reference_params`.
    """

    def __init__(self, cfg: PNAConfig, *, generator=None,
                 device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = _linear(cfg.d_in, cfg.d_hidden, cfg, generator, dev)
        self.layers = nn.ModuleList(
            PNALayer(cfg, generator, dev) for _ in range(cfg.n_layers))
        self.head = _linear(cfg.d_hidden, cfg.n_out, cfg, generator, dev)

    def forward(self, batch: GraphBatch,
                edges: EdgeShards | None = None) -> torch.Tensor:
        """Node logits [n_node, n_out], or the graph readout [G, n_out];
        ``edges`` (default: the batch's own, one shard) as
        ``graph.EdgeShards`` gives them."""
        edges = EdgeShards.whole(batch) if edges is None else edges
        h = F.silu(self.embed(batch.nodes.to(self.cfg.dtype)))
        for layer in self.layers:
            h = layer(h, batch, edges)
        out = self.head(h)
        if self.cfg.node_level:
            return out[:batch.n_node]
        out = out * batch.node_mask[:, None].to(out.dtype)
        return graph_readout(out, batch.graph_id, batch.n_graph, "mean")

    @torch.no_grad()
    def load_reference_params(self, tree) -> "PNA":
        """Copy the reference's parameter tree (``pna.init_params``,
        leaves converted to numpy) into this module."""
        def put(lin: nn.Linear, p) -> None:
            w = torch.tensor(np.asarray(p["w"]))
            b = torch.tensor(np.asarray(p["b"]))
            if tuple(w.shape) != (lin.in_features, lin.out_features):
                raise ValueError(
                    f"reference weight {tuple(w.shape)} does not fit "
                    f"[{lin.in_features}, {lin.out_features}]")
            lin.weight.copy_(w.t())
            lin.bias.copy_(b)

        if len(tree["layers"]) != len(self.layers):
            raise ValueError(f"reference has {len(tree['layers'])} layers, "
                             f"this PNA {len(self.layers)}")
        put(self.embed, tree["embed"])
        for layer, p in zip(self.layers, tree["layers"]):
            put(layer.msg, p["msg"])
            put(layer.upd, p["upd"])
        put(self.head, tree["head"])
        return self


def param_specs(cfg: PNAConfig) -> dict:
    """Replicated specs of this model's parameter tree
    (``graph.replicated_specs``), from a module built on the meta
    device."""
    return replicated_specs(PNA(cfg, device="meta"))


def make_loss(model: PNA):
    """The reference's ``make_loss`` (``pna.py:108``): loss_fn(params,
    (batch, labels)) -> the mean float32 cross-entropy of ``model``'s
    logits; ``params`` by parameter name (``graph.mse_loss``)."""
    def loss_fn(params, batch_and_labels):
        batch, labels = batch_and_labels
        logits = torch.func.functional_call(model, params, (batch,))
        return softmax_cross_entropy(logits, labels)
    return loss_fn
