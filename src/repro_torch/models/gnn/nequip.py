"""NequIP: equivariant interatomic potentials [Batzner et al.,
arXiv:2101.03164], on ``repro_torch.models.gnn.irreps``.

Port of ``repro.models.gnn.nequip``.  Interaction block (per layer):

    msg_ij = sum_paths  W_path(rbf(r_ij))[c] * CG_(l1,l2->l3)
                        ( h_j[c, l1] (x) Y_l2(r^_ij) )
    h_i'   = SelfInteract_l( h_i + (1/sqrt(deg_avg)) sum_j msg_ij )
    h_i''  = Gate(h_i')           # scalars: silu; l>0: sigmoid-scalar gate

The tensor product is channel-wise ("depthwise") with per-path radial
weights over the 15 paths at l_max 2; each path's CG tensor is a buffer
on the module's device.  Weights are held in the reference's ``[in,
out]`` layout.

Each edge shard (``graph.EdgeShards``: one on one device) computes its
geometry once, then a layer's messages with its own ``radial`` weights
and their partial ``agg_sum``; the shards' sums are added, then divided
by ``sqrt(avg_degree)`` as on one device, and the node update runs once.

Dtype: everything stays in ``cfg.dtype`` (float32).  The reference
divides the aggregate by ``np.sqrt(avg_degree)``, a numpy float64 scalar,
which under the reference package's global x64 flag promotes its
features to float64 from the first layer on; the port does not copy
that promotion (ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import MLP, copy_param, dense_init
from repro_torch.models.gnn import irreps as IR
from repro_torch.models.gnn.graph import (EdgeShards, GraphBatch, agg_sum,
                                          graph_readout, mse_loss,
                                          replicated_specs)


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channel multiplicity per degree
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16              # species embedding input dim
    n_out: int = 1
    radial_hidden: int = 64
    avg_degree: float = 10.0
    dtype: Any = torch.float32

    @property
    def comps(self) -> int:
        return IR.num_comps(self.l_max)

    @property
    def paths(self):
        return IR.allowed_paths(self.l_max, self.l_max, self.l_max)


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float,
               eps: float = 1e-9) -> torch.Tensor:
    """Bessel basis sqrt(2/c) sin(k pi r / c) / r with polynomial cutoff."""
    k = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rr = torch.clamp(r, min=eps)[..., None]
    basis = math.sqrt(2.0 / cutoff) * torch.sin(k * math.pi * rr / cutoff) / rr
    # smooth polynomial envelope (p = 6)
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 28 * x**6 + 48 * x**7 - 21 * x**8
    return basis * env[..., None]


class NequIPLayer(nn.Module):
    def __init__(self, cfg: NequIPConfig, generator, device) -> None:
        super().__init__()
        c = cfg.d_hidden
        kw = dict(generator=generator, dtype=cfg.dtype, device=device)
        self.cfg = cfg
        # radial MLP: rbf -> per-(path, channel) TP weights
        self.radial = MLP([cfg.n_rbf, cfg.radial_hidden,
                           len(cfg.paths) * c], **kw)
        # self-interaction: per-degree channel mixing
        self.self_mix = nn.ParameterList(
            dense_init(c, c, **kw) for _ in range(cfg.l_max + 1))
        # gate scalars for l > 0
        self.gate = nn.Parameter(dense_init(c, c * cfg.l_max, **kw))
        for p, (l1, l2, l3) in enumerate(cfg.paths):
            self.register_buffer(f"cg{p}", torch.as_tensor(
                IR.cg_real(l1, l2, l3), dtype=cfg.dtype, device=device),
                persistent=False)

    def tensor_product(self, h_src, Y, w):
        """Depthwise TP: h_src [E, C, K], Y [E, K], w [E, n_paths, C] ->
        messages [E, C, K]."""
        cfg = self.cfg
        out = h_src.new_zeros((h_src.shape[0], cfg.d_hidden, cfg.comps))
        for p, (l1, l2, l3) in enumerate(cfg.paths):
            cg = getattr(self, f"cg{p}")                 # [2l1+1, 2l2+1, 2l3+1]
            lhs = h_src[..., IR.l_slice(l1)]              # [E, C, 2l1+1]
            rhs = Y[..., IR.l_slice(l2)]                  # [E, 2l2+1]
            # einsum("ijk,eci,ej->eck"): Y folded into the CG first
            m = lhs @ torch.einsum("ijk,ej->eik", cg, rhs)
            out[..., IR.l_slice(l3)] += m * w[:, p, :, None]
        return out

    #: The submodules each edge shard runs with its own parameters.
    EDGE = ("radial",)

    def edge_sum(self, shard, h, geo, n_node: int):
        """One edge shard's partial ``agg_sum`` of its messages [N + 1,
        C, K]; ``geo`` = (Y, rbf) of its edges."""
        cfg = self.cfg
        Y, rbf = geo
        w = self.radial(rbf).reshape(-1, len(cfg.paths), cfg.d_hidden)
        w = w * (shard.senders != n_node)[:, None, None].to(w.dtype)
        msgs = self.tensor_product(h[shard.senders], Y, w)
        return agg_sum(msgs, shard.receivers, n_node + 1)

    def forward(self, h, batch: GraphBatch, edges: EdgeShards, geos):
        cfg = self.cfg
        c = cfg.d_hidden
        parts = [sh.call(self, self.EDGE, NequIPLayer.edge_sum, sh, hd, geo,
                         batch.n_node)
                 for sh, hd, geo in zip(edges, edges.on_shards(h), geos)]
        h = h + edges.sum(parts) / math.sqrt(cfg.avg_degree)
        # self interaction per degree: einsum("cd,ncm->ndm")
        h = torch.cat([self.self_mix[l].t() @ h[..., IR.l_slice(l)]
                       for l in range(cfg.l_max + 1)], dim=-1)
        # gate nonlinearity
        scal = h[..., 0]                                  # [N+1, C]
        gates = torch.sigmoid(scal @ self.gate).reshape(-1, cfg.l_max, c)
        new = [F.silu(scal)[..., None]]
        for l in range(1, cfg.l_max + 1):
            new.append(h[..., IR.l_slice(l)] * gates[:, l - 1, :, None])
        return torch.cat(new, dim=-1)


class NequIP(nn.Module):
    """embed -> ``n_layers`` interaction blocks -> head on the scalars.
    Weights come from ``generator`` (default: a CPU generator seeded 0)
    unless carried across with :meth:`load_reference_params`."""

    def __init__(self, cfg: NequIPConfig, *, generator=None,
                 device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(generator=generator, dtype=cfg.dtype, device=dev)
        c = cfg.d_hidden
        self.cfg = cfg
        self.embed = MLP([cfg.d_in, c], **kw)
        self.layers = nn.ModuleList(
            NequIPLayer(cfg, generator, dev) for _ in range(cfg.n_layers))
        self.head = MLP([c, c, cfg.n_out], **kw)

    def geometry(self, shard, pos):
        """One edge shard's (Y, rbf): its edges' spherical harmonics and
        radial basis, computed once for every layer."""
        cfg = self.cfg
        rel = pos[shard.receivers] - pos[shard.senders]
        dist = torch.linalg.norm(rel, dim=-1)
        return (IR.sph_harm(cfg.l_max, rel).to(cfg.dtype),
                bessel_rbf(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype))

    def forward(self, batch: GraphBatch, edges: EdgeShards | None = None):
        """Returns (graph energies [G, n_out], node irreps [N+1, C, K]);
        ``edges`` (default: the batch's own, one shard) as
        ``graph.EdgeShards`` gives them."""
        cfg = self.cfg
        edges = EdgeShards.whole(batch) if edges is None else edges
        geos = [self.geometry(sh, pos) for sh, pos in
                zip(edges, edges.on_shards(batch.pos))]

        h0 = self.embed(batch.nodes.to(cfg.dtype))        # [N+1, C]
        h = h0.new_zeros((batch.n_node + 1, cfg.d_hidden, cfg.comps))
        h[..., 0] = h0
        for layer in self.layers:
            h = layer(h, batch, edges, geos)
        node_e = self.head(h[..., 0])
        node_e = node_e * batch.node_mask[:, None].to(node_e.dtype)
        g = graph_readout(node_e, batch.graph_id, batch.n_graph, "sum")
        return g, h

    def node_forward(self, batch: GraphBatch,
                     edges: EdgeShards | None = None) -> torch.Tensor:
        """Node-level outputs [n_node, n_out] (classification shapes)."""
        _, h = self.forward(batch, edges)
        return self.head(h[..., 0])[:batch.n_node]

    @torch.no_grad()
    def load_reference_params(self, tree) -> "NequIP":
        """Copy the reference's parameter tree (``nequip.init_params``,
        leaves as numpy arrays) into this module."""
        if len(tree["layers"]) != len(self.layers):
            raise ValueError(f"reference has {len(tree['layers'])} layers, "
                             f"this NequIP {len(self.layers)}")
        self.embed.load(tree["embed"])
        for layer, p in zip(self.layers, tree["layers"]):
            layer.radial.load(p["radial"])
            if len(p["self"]) != len(layer.self_mix):
                raise ValueError(f"reference has {len(p['self'])} "
                                 f"self-interaction degrees")
            for dst, src in zip(layer.self_mix, p["self"]):
                copy_param(dst, src)
            copy_param(layer.gate, p["gate"])
        self.head.load(tree["head"])
        return self


def param_specs(cfg: NequIPConfig) -> dict:
    """Replicated specs of this model's parameter tree
    (``graph.replicated_specs``), from a module built on the meta
    device."""
    return replicated_specs(NequIP(cfg, device="meta"))


def make_loss(model: NequIP):
    """The reference's ``make_loss`` (``nequip.py:187``): loss_fn(params,
    (batch, target)) -> mean squared error of ``model``'s graph outputs;
    ``params`` by parameter name (``graph.mse_loss``)."""
    return mse_loss(model)


__all__ = ["NequIP", "NequIPConfig", "NequIPLayer", "bessel_rbf",
           "make_loss", "param_specs"]
