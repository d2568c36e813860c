"""Equiformer-v2: equivariant graph attention via eSCN convolutions
[Liao et al., arXiv:2306.12059; Passaro & Zitnick, arXiv:2302.03655].

Port of ``repro.models.gnn.equiformer_v2``.  Each edge's features are
rotated into a frame where the edge direction is the SH polar axis; in
that frame an equivariant convolution with SH filters is an *SO(2)
linear* that only mixes components of equal |m|, truncated to |m| <=
m_max (here 2).

Layer = equivariant-norm -> eSCN multi-head attention -> residual ->
equivariant-norm -> gated FFN -> residual.

* The per-edge Wigner blocks come from the CG recurrence
  (``irreps.wigner_d``) and are recomputed inside every layer, as the
  reference does; the recurrence's CG tensors are buffers on the
  module's device.
* The m-truncated representation is three dense tensors (m = 0 real,
  m = 1, 2 as (+m, -m) pairs), so every SO(2) linear is one matmul over
  an [E, *] operand.  Its component indices are buffers too
  (:class:`MIndex`).
* The aggregations are the port's ``agg_sum`` / ``agg_max``
  (``index_add_`` / ``scatter_reduce_``), as the reference's are
  ``jax.ops.segment_sum`` / ``segment_max``.
* Each edge shard (``graph.EdgeShards``: one on one device) computes its
  messages and logits with its own ``so2`` / ``alpha`` weights; the
  segment softmax runs across the shards (:func:`segment_softmax`: the
  element-wise max of the shards' maxima, each shard's ``exp`` against
  it, the denominators summed), each shard's weighted messages are
  summed, and ``out_project`` and the rest of the layer run once on the
  summed aggregate.

Weights are held in the reference's ``[in, out]`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import Dense, copy_param, dense_init
from repro_torch.models.gnn import irreps as IR
from repro_torch.models.gnn.graph import (EdgeShard, EdgeShards, GraphBatch,
                                          agg_max, agg_sum, graph_readout,
                                          mse_loss, replicated_specs)


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128          # sphere channels
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 16
    n_out: int = 1
    n_rbf: int = 64              # gaussian distance basis
    cutoff: float = 5.0
    ffn_mult: int = 2
    dtype: Any = torch.float32

    @property
    def comps(self) -> int:
        return IR.num_comps(self.l_max)

    def n_l(self, m: int) -> int:
        """Number of degrees carrying an |m| component."""
        return self.l_max + 1 - m


def gaussian_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    # the reference's linspace is float64 (its package runs with x64 on),
    # then cast to r's dtype
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float64,
                             device=r.device).to(r.dtype)
    width = cutoff / n_rbf
    return torch.exp(-((r[..., None] - centers) / width) ** 2)


# -------------------------------------------------------------------------
# m-truncated representation <-> full irreps
# -------------------------------------------------------------------------
def _m_indices(cfg: EquiformerV2Config, m: int):
    """Flat component indices of (+m, -m) per degree l >= m."""
    plus = [l * l + l + m for l in range(m, cfg.l_max + 1)]
    minus = [l * l + l - m for l in range(m, cfg.l_max + 1)]
    return np.asarray(plus), np.asarray(minus)


class MIndex(nn.Module):
    """The component indices of :func:`to_m_rep` / :func:`from_m_rep` as
    int64 buffers on one device: ``index(m)`` -> (plus, minus)."""

    def __init__(self, cfg: EquiformerV2Config, device) -> None:
        super().__init__()
        for m in range(cfg.m_max + 1):
            plus, minus = _m_indices(cfg, m)
            self.register_buffer(f"plus{m}", torch.as_tensor(
                plus, dtype=torch.int64, device=device), persistent=False)
            self.register_buffer(f"minus{m}", torch.as_tensor(
                minus, dtype=torch.int64, device=device), persistent=False)

    def index(self, m: int):
        return getattr(self, f"plus{m}"), getattr(self, f"minus{m}")


def to_m_rep(cfg: EquiformerV2Config, x: torch.Tensor, idx: MIndex):
    """x [..., C, K] -> (m0 [..., C, L+1], [(xp, xm) per m=1..m_max])."""
    m0 = x[..., idx.index(0)[0]]
    pairs = []
    for m in range(1, cfg.m_max + 1):
        pl, mi = idx.index(m)
        pairs.append((x[..., pl], x[..., mi]))
    return m0, pairs


def from_m_rep(cfg: EquiformerV2Config, m0: torch.Tensor, pairs, shape,
               idx: MIndex) -> torch.Tensor:
    """Inverse of :func:`to_m_rep` into a tensor of ``shape`` [..., K];
    components with |m| > m_max are zero."""
    out = m0.new_zeros(tuple(shape)[:-1] + (cfg.comps,))
    out[..., idx.index(0)[0]] = m0
    for m, (xp, xm) in enumerate(pairs, start=1):
        pl, mi = idx.index(m)
        out[..., pl] = xp
        out[..., mi] = xm
    return out


# -------------------------------------------------------------------------
# The SO(2) linear
# -------------------------------------------------------------------------
class SO2Linear(nn.Module):
    """SO(2) linear weights: an m=0 real matrix (with bias, the distance
    basis appended to its input) and a complex (Wr, Wi) pair per m>0."""

    def __init__(self, cfg: EquiformerV2Config, c_in_mult: int, *,
                 generator, dtype, device) -> None:
        super().__init__()
        c = cfg.d_hidden
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.cfg = cfg
        self.m0 = Dense(c_in_mult * c * (cfg.l_max + 1) + cfg.n_rbf,
                        c * (cfg.l_max + 1), **kw)
        for m in range(1, cfg.m_max + 1):
            din, dout = c_in_mult * c * cfg.n_l(m), c * cfg.n_l(m)
            setattr(self, f"m{m}r", nn.Parameter(dense_init(din, dout, **kw)))
            setattr(self, f"m{m}i", nn.Parameter(dense_init(din, dout, **kw)))

    def forward(self, m0_in, pairs_in, rbf):
        """m0_in [E, *], pairs [E, *] -> (m0 [E, C, L+1], pairs
        [(E, C, n_l) x2])."""
        cfg = self.cfg
        e = m0_in.shape[0]
        c = cfg.d_hidden
        m0_flat = torch.cat([m0_in.reshape(e, -1), rbf.to(m0_in.dtype)],
                            dim=-1)
        m0 = self.m0(m0_flat).reshape(e, c, cfg.l_max + 1)
        pairs = []
        for m, (xp, xm) in enumerate(pairs_in, start=1):
            zp, zm = xp.reshape(e, -1), xm.reshape(e, -1)
            wr, wi = getattr(self, f"m{m}r"), getattr(self, f"m{m}i")
            op = (zp @ wr - zm @ wi).reshape(e, c, cfg.n_l(m))
            om = (zm @ wr + zp @ wi).reshape(e, c, cfg.n_l(m))
            pairs.append((op, om))
        return m0, pairs

    def load(self, p) -> None:
        self.m0.load(p["m0"])
        for m in range(1, self.cfg.m_max + 1):
            copy_param(getattr(self, f"m{m}r"), p[f"m{m}r"])
            copy_param(getattr(self, f"m{m}i"), p[f"m{m}i"])


# -------------------------------------------------------------------------
# Attention block
# -------------------------------------------------------------------------
def segment_softmax(logits, masks, edges: EdgeShards, n_rows: int):
    """Each shard's logits [E_s, H] -> its edges' softmax weights over
    the edges of their segment (receiver) in every shard; ``masks``
    [E_s] bool, each shard's live edges.  The masked logits are -inf
    before the segment max, which is the element-wise max of the shards'
    maxima; its -inf (a row with no live edge in any shard, the dump
    row's) becomes 0 only then.  Each shard takes ``exp`` against that
    shared max, the denominators are summed across the shards, and
    masked edges weigh 0: on one shard, the reference's
    ``_segment_softmax``."""
    masks = [m[:, None] for m in masks]
    logits = [torch.where(m, x, -torch.inf) for m, x in zip(masks, logits)]
    mx = torch.nan_to_num(edges.max([agg_max(x, sh.receivers, n_rows)
                                     for sh, x in zip(edges, logits)]),
                          neginf=0.0)
    ex = [torch.where(m, torch.exp(x - top[sh.receivers]), 0.0)
          for sh, m, x, top in zip(edges, masks, logits,
                                   edges.on_shards(mx))]
    den = edges.sum([agg_sum(e, sh.receivers, n_rows)
                     for sh, e in zip(edges, ex)])
    return [e / (d[sh.receivers] + 1e-9)
            for sh, e, d in zip(edges, ex, edges.on_shards(den))]


def _segment_softmax(logits, seg, n_rows: int, mask):
    """logits [E, H] -> softmax over edges per segment (receiver), on one
    device: :func:`segment_softmax` of one shard."""
    one = EdgeShards([EdgeShard(logits.device, seg, seg)], logits.device)
    return segment_softmax([logits], [mask], one, n_rows)[0]


def inverse_wigner(Ds):
    """The blocks that rotate the messages back to the global frame: the
    transposes (inverses) of ``Ds``."""
    return [D.transpose(-1, -2) for D in Ds]


def edge_messages(layer: "EquiformerV2Layer", x_src, x_dst, rel,
                  cfg: EquiformerV2Config):
    """Shared eSCN message core: (x_src, x_dst) [E, C, K] + rel [E, 3]
    -> (msg [E, C, K] rotated back to the global frame, alpha logits
    [E, H]).  Intermediates are dropped as soon as they are used: at
    ``minibatch_lg`` one [E, C, K] float32 buffer is 4.24 GB."""
    dist = torch.sqrt((rel * rel).sum(dim=-1) + 1e-18)  # finite at 0
    rbf = gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff)
    Ds = IR.wigner_d(cfg.l_max, IR.rot_to_polar(rel), layer.cgs())
    idx = layer.m_index
    xs = IR.apply_wigner(cfg.l_max, Ds, x_src)
    del x_src
    shape = tuple(xs.shape)
    m0s, ps = to_m_rep(cfg, xs, idx)
    del xs
    m0d, pd = to_m_rep(cfg, IR.apply_wigner(cfg.l_max, Ds, x_dst), idx)
    del x_dst
    m0_in = torch.cat([m0s, m0d], dim=-2)                # [E, 2C, L+1]
    pairs_in = [(torch.cat([a, c2], dim=-2), torch.cat([b, d2], dim=-2))
                for (a, b), (c2, d2) in zip(ps, pd)]
    del m0s, ps, m0d, pd
    m0, pairs = layer.so2(m0_in, pairs_in, rbf)
    del m0_in, pairs_in
    m0 = F.silu(m0)
    alpha = F.leaky_relu(layer.alpha(m0.reshape(m0.shape[0], -1)),
                         0.2)                            # [E, H]
    msg = from_m_rep(cfg, m0, pairs, shape, idx)
    del m0, pairs
    return IR.apply_wigner(cfg.l_max, inverse_wigner(Ds), msg), alpha


def head_weight(alpha_w, msg, cfg: EquiformerV2Config):
    """Scale value channels by per-head attention weights [E, H]: head h
    owns channels [h * C / H, (h + 1) * C / H)."""
    hsz = cfg.d_hidden // cfg.n_heads
    return msg * torch.repeat_interleave(alpha_w, hsz, dim=-1)[..., None]


def out_project(weights, agg, cfg: EquiformerV2Config):
    """Per-degree channel mixing, einsum("cd,ncm->ndm") with
    ``weights[l]`` on degree l."""
    return torch.cat([weights[l].t() @ agg[..., IR.l_slice(l)]
                      for l in range(cfg.l_max + 1)], dim=-1)


class EquiformerV2Layer(nn.Module):
    def __init__(self, cfg: EquiformerV2Config, generator, device) -> None:
        super().__init__()
        c = cfg.d_hidden
        kw = dict(generator=generator, dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.m_index = MIndex(cfg, device)
        ones = torch.ones((c, cfg.l_max + 1), dtype=cfg.dtype, device=device)
        self.norm1 = nn.Parameter(ones.clone())
        self.so2 = SO2Linear(cfg, 2, **kw)               # src+dst features
        self.alpha = Dense(c * (cfg.l_max + 1), cfg.n_heads, **kw)
        self.out = nn.ParameterList(
            dense_init(c, c, **kw) for _ in range(cfg.l_max + 1))
        self.norm2 = nn.Parameter(ones.clone())
        self.ffn_in = Dense(c, cfg.ffn_mult * c, **kw)
        self.ffn_out = Dense(cfg.ffn_mult * c, c, **kw)
        self.ffn_gate = nn.Parameter(dense_init(c, c * cfg.l_max, **kw))
        self.ffn_self = nn.ParameterList(
            dense_init(c, c, **kw) for _ in range(cfg.l_max + 1))
        for i, w in enumerate(IR.wigner_cgs(cfg.l_max, cfg.dtype, device)):
            self.register_buffer(f"cg{i}", w, persistent=False)

    def cgs(self) -> list:
        return [getattr(self, f"cg{i}") for i in range(self.cfg.l_max - 1)]

    #: The submodules each edge shard runs with its own parameters.
    EDGE = ("so2", "alpha")

    def edge_messages(self, shard, x, pos):
        """One edge shard's (messages [E_s, C, K], logits [E_s, H])."""
        s, r = shard.senders, shard.receivers
        rel = (pos[r] - pos[s]).to(x.dtype)
        return edge_messages(self, x[s], x[r], rel, self.cfg)

    def attn(self, x, batch: GraphBatch, edges: EdgeShards):
        cfg = self.cfg
        n1 = batch.n_node + 1
        outs = [sh.call(self, self.EDGE, EquiformerV2Layer.edge_messages,
                        sh, xd, pd)
                for sh, xd, pd in zip(edges, edges.on_shards(x),
                                      edges.on_shards(batch.pos))]
        masks = [sh.senders != batch.n_node for sh in edges]
        alphas = segment_softmax([a for _, a in outs], masks, edges,
                                 n1)                      # [E_s, H] each
        parts = []
        for i, sh in enumerate(edges):
            msg = head_weight(alphas[i], outs[i][0], cfg)
            outs[i] = alphas[i] = None        # each [E_s, C, K] freed early
            msg = msg * masks[i][:, None, None].to(msg.dtype)
            parts.append(agg_sum(msg, sh.receivers, n1))
        return out_project(self.out, edges.sum(parts), cfg)

    def ffn(self, x):
        cfg = self.cfg
        scal = x[..., 0]
        hid = F.silu(self.ffn_in(scal))
        scal_out = self.ffn_out(hid)
        gates = torch.sigmoid(scal @ self.ffn_gate).reshape(
            tuple(scal.shape[:-1]) + (cfg.l_max, cfg.d_hidden))
        outs = [scal_out[..., None]]
        for l in range(1, cfg.l_max + 1):
            blk = self.ffn_self[l].t() @ x[..., IR.l_slice(l)]
            outs.append(blk * gates[..., l - 1, :][..., None])
        return torch.cat(outs, dim=-1)

    def forward(self, x, batch: GraphBatch, edges: EdgeShards):
        l_max = self.cfg.l_max
        x = x + self.attn(IR.equivariant_rms_norm(l_max, x, self.norm1),
                          batch, edges)
        return x + self.ffn(IR.equivariant_rms_norm(l_max, x, self.norm2))

    def load(self, p) -> None:
        copy_param(self.norm1, p["norm1"])
        self.so2.load(p["so2"])
        self.alpha.load(p["alpha"])
        for dst, src in zip(self.out, p["out"], strict=True):
            copy_param(dst, src)
        copy_param(self.norm2, p["norm2"])
        self.ffn_in.load(p["ffn_in"])
        self.ffn_out.load(p["ffn_out"])
        copy_param(self.ffn_gate, p["ffn_gate"])
        for dst, src in zip(self.ffn_self, p["ffn_self"], strict=True):
            copy_param(dst, src)


class EquiformerV2(nn.Module):
    """embed -> ``n_layers`` eSCN attention layers -> head on the
    scalars.  Weights come from ``generator`` (default: a CPU generator
    seeded 0) unless carried across with :meth:`load_reference_params`."""

    def __init__(self, cfg: EquiformerV2Config, *, generator=None,
                 device="cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(generator=generator, dtype=cfg.dtype, device=dev)
        self.cfg = cfg
        self.embed = Dense(cfg.d_in, cfg.d_hidden, **kw)
        self.layers = nn.ModuleList(
            EquiformerV2Layer(cfg, generator, dev)
            for _ in range(cfg.n_layers))
        self.head = Dense(cfg.d_hidden, cfg.n_out, **kw)

    def forward(self, batch: GraphBatch, edges: EdgeShards | None = None):
        """Returns (graph outputs [G, n_out], node irreps [N+1, C, K]);
        ``edges`` (default: the batch's own, one shard) as
        ``graph.EdgeShards`` gives them."""
        cfg = self.cfg
        edges = EdgeShards.whole(batch) if edges is None else edges
        h0 = self.embed(batch.nodes.to(cfg.dtype))
        x = h0.new_zeros((batch.n_node + 1, cfg.d_hidden, cfg.comps))
        x[..., 0] = h0
        for layer in self.layers:
            x = layer(x, batch, edges)
        node_out = self.head(x[..., 0])
        node_out = node_out * batch.node_mask[:, None].to(node_out.dtype)
        g = graph_readout(node_out, batch.graph_id, batch.n_graph, "sum")
        return g, x

    def node_forward(self, batch: GraphBatch,
                     edges: EdgeShards | None = None) -> torch.Tensor:
        """Node-level outputs [n_node, n_out] (classification shapes)."""
        _, x = self.forward(batch, edges)
        return self.head(x[..., 0])[:batch.n_node]

    @torch.no_grad()
    def load_reference_params(self, tree) -> "EquiformerV2":
        """Copy the reference's parameter tree
        (``equiformer_v2.init_params``, leaves as numpy arrays) into
        this module."""
        if len(tree["layers"]) != len(self.layers):
            raise ValueError(f"reference has {len(tree['layers'])} layers, "
                             f"this Equiformer-v2 {len(self.layers)}")
        self.embed.load(tree["embed"])
        for layer, p in zip(self.layers, tree["layers"]):
            layer.load(p)
        self.head.load(tree["head"])
        return self


def param_specs(cfg: EquiformerV2Config) -> dict:
    """Replicated specs of this model's parameter tree
    (``graph.replicated_specs``), from a module built on the meta
    device."""
    return replicated_specs(EquiformerV2(cfg, device="meta"))


def make_loss(model: EquiformerV2):
    """The reference's ``make_loss`` (``equiformer_v2.py:287``): loss_fn(params,
    (batch, target)) -> mean squared error of ``model``'s graph outputs;
    ``params`` by parameter name (``graph.mse_loss``)."""
    return mse_loss(model)


__all__ = ["EquiformerV2", "EquiformerV2Config", "EquiformerV2Layer",
           "MIndex", "SO2Linear", "edge_messages", "from_m_rep",
           "gaussian_rbf", "head_weight", "inverse_wigner", "make_loss",
           "out_project", "param_specs", "segment_softmax", "to_m_rep"]
