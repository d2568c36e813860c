"""Ring-partitioned equivariant graph attention (port of
``repro.models.gnn.ring``).

A full-batch Equiformer-v2 on ``ogb_products`` keeps node irreps of
[2.45M, 128, 49] -- 61 GiB a device when every device holds them all --
so the reference shards the node state and fetches remote sender rows
around a ring.  The scheme, exact up to float32 summation order:

* nodes are partitioned into ``p_data`` blocks, each with a dump row
  appended (:func:`blocked_layout`); block ``d`` lives on the ``data``
  coordinate ``d`` and is replicated over ``model``;
* edges are bucketed on the host by (dst block d, model column m, ring
  step s), ``s = (d - src block) mod p_data``, into fixed-capacity
  buckets (:func:`bucket_edges`); mesh entry (d, m) holds buckets
  ``[d, m]``;
* ring step ``s`` brings the sender block at ring distance ``s`` to
  entry (d, m): block ``(d - s) mod p_data``, the reference's one
  ``ppermute`` of :func:`_shift_perm`.  One controller drives every
  entry here, so the fetch is a copy of that block to the entry's device
  (no copy where it already lies);
* the softmax over a node's incoming edges runs in two phases so that no
  large accumulator is carried through the steps: phase 1, under
  ``torch.no_grad()`` (the max shift needs no gradient), a streaming
  segment max of the attention logits, then the max over the ``model``
  entries (``pmax``); phase 2, each step under ``torch.utils.checkpoint``
  (the reference trains through it), the per-step numerator and
  denominator sums, then their sums over ``model`` (``psum``), the
  ``1e-30`` floor and one division.  The masks come before ``exp``, as
  the reference's do.

Outside the attention -- the embedding, the equivariant RMS norms,
``out_project`` and the FFN -- :func:`forward_ring` runs on the
controller's device over the whole blocked layout: they act node by
node, and the graphs run here fit one card (``ogb_products``, which
would need them node-sharded, is not run).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.gnn import irreps as IR
from repro_torch.models.gnn.equiformer_v2 import (edge_messages,
                                                  head_weight, out_project)
from repro_torch.models.gnn.graph import agg_max, agg_sum


# -------------------------------------------------------------------------
# Host-side bucketing
# -------------------------------------------------------------------------
def bucket_edges(senders, receivers, n_nodes: int, p_data: int,
                 p_model: int, cap: int | None = None):
    """Bucket edges by (dst block, model column, ring step).

    Returns (src_loc, dst_loc) int32[p_data, p_model, p_data, cap] with
    pad sentinel = n_loc (the dump row of each block), n_loc, and the
    number of edges dropped past ``cap``.  Model columns are filled
    round-robin per (d, s) for load balance."""
    n_loc = -(-n_nodes // p_data)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    d_blk = receivers // n_loc
    s_blk = senders // n_loc
    step = (d_blk - s_blk) % p_data
    buckets_src = [[[[] for _ in range(p_data)] for _ in range(p_model)]
                   for _ in range(p_data)]
    buckets_dst = [[[[] for _ in range(p_data)] for _ in range(p_model)]
                   for _ in range(p_data)]
    rr = {}
    for e in range(len(senders)):
        d, s = int(d_blk[e]), int(step[e])
        m = rr.get((d, s), 0)
        rr[(d, s)] = (m + 1) % p_model
        buckets_src[d][m][s].append(int(senders[e] % n_loc))
        buckets_dst[d][m][s].append(int(receivers[e] % n_loc))
    if cap is None:
        cap = max(1, max((len(b) for row in buckets_src for col in row
                          for b in col), default=1))
    src = np.full((p_data, p_model, p_data, cap), n_loc, np.int32)
    dst = np.full((p_data, p_model, p_data, cap), n_loc, np.int32)
    dropped = 0
    for d in range(p_data):
        for m in range(p_model):
            for s in range(p_data):
                bs = buckets_src[d][m][s][:cap]
                bd = buckets_dst[d][m][s][:cap]
                dropped += max(len(buckets_src[d][m][s]) - cap, 0)
                src[d, m, s, :len(bs)] = bs
                dst[d, m, s, :len(bd)] = bd
    return src, dst, n_loc, dropped


def bucket_specs(n_nodes: int, n_edges: int, p_data: int, p_model: int,
                 slack: float = 4.0):
    """The buckets' shapes for a graph of this size (capacity from
    ``slack`` times the mean fill, a multiple of 8): (src, dst) as int32
    tensors on the meta device, and n_loc."""
    n_loc = -(-n_nodes // p_data)
    cap = int(np.ceil(n_edges * slack / (p_data * p_model * p_data)))
    cap = max(-(-cap // 8) * 8, 8)
    shape = (p_data, p_model, p_data, cap)
    return (torch.empty(shape, dtype=torch.int32, device="meta"),
            torch.empty(shape, dtype=torch.int32, device="meta"), n_loc)


def blocked_layout(node_feat, pos, n_nodes: int, p_data: int):
    """Host-side: rearrange [N, F] into p_data blocks each with a dump
    row appended -> [p_data * (n_loc + 1), F] (and positions alike)."""
    n_loc = -(-n_nodes // p_data)
    f = node_feat.shape[1]
    out = np.zeros((p_data * (n_loc + 1), f), node_feat.dtype)
    pout = np.zeros((p_data * (n_loc + 1), 3), pos.dtype)
    for b in range(p_data):
        lo, hi = b * n_loc, min((b + 1) * n_loc, n_nodes)
        out[b * (n_loc + 1): b * (n_loc + 1) + (hi - lo)] = node_feat[lo:hi]
        pout[b * (n_loc + 1): b * (n_loc + 1) + (hi - lo)] = pos[lo:hi]
    return out, pout, n_loc


def unblock(x, n_nodes: int, p_data: int):
    """Inverse of :func:`blocked_layout` on the node axis: the real rows
    of each block, in node order."""
    n_loc = -(-n_nodes // p_data)
    return torch.cat([x[b * (n_loc + 1): b * (n_loc + 1) + (
        min((b + 1) * n_loc, n_nodes) - b * n_loc)] for b in range(p_data)])


# -------------------------------------------------------------------------
# Device code
# -------------------------------------------------------------------------
def _shift_perm(p_data: int, s: int):
    """The reference's ppermute pairs: entry i sends its block to entry
    (i + s) mod p_data, so entry d receives block (d - s) mod p_data."""
    return [(i, (i + s) % p_data) for i in range(p_data)]


def _source_block(d: int, s: int, p_data: int) -> int:
    """The block entry ``d`` holds at ring step ``s`` (by
    :func:`_shift_perm`)."""
    return next(i for i, j in _shift_perm(p_data, s) if j == d)


class _Messages(nn.Module):
    def __init__(self, layer) -> None:
        super().__init__()
        self.layer = layer

    def forward(self, x_src, x_dst, rel):
        return edge_messages(self.layer, x_src, x_dst, rel, self.layer.cfg)


def _messages_on(layer, dev: torch.device):
    """``edge_messages`` of ``layer`` computed on ``dev``: directly where
    the layer lies, else through copies of its weights and buffers on
    ``dev`` (differentiable copies: the gradient reaches the layer's own
    parameters)."""
    if next(layer.parameters()).device == dev:
        return lambda *a: edge_messages(layer, *a, layer.cfg)
    wrapper = _Messages(layer)
    tensors = {n: t.to(dev) for n, t in
               list(wrapper.named_parameters()) +
               list(wrapper.named_buffers())}
    return lambda *a: torch.func.functional_call(wrapper, tensors, a)


def _pmax(parts, dev: torch.device) -> torch.Tensor:
    """The elementwise max of the ``model`` entries' parts, on ``dev``."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev))
    return out


def _psum(parts, dev: torch.device) -> torch.Tensor:
    """The sum of the ``model`` entries' parts on ``dev``, in entry
    order."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _entry_devices(mesh):
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"the ring runs over a ('data', 'model') mesh, "
                         f"got {mesh.axis_names}")
    return mesh.devices


def ring_attention(layer, h: torch.Tensor, pos: torch.Tensor, src_b, dst_b,
                   mesh) -> torch.Tensor:
    """One layer's ring attention (the reference's ``make_ring_attn``
    and ``_ring_attn_local``): ``h`` [p_data * (n_loc + 1), C, K] and
    ``pos`` [.., 3] in the blocked layout on the controller's device,
    buckets (src, dst) [p_data, p_model, p_data, cap] -> the aggregated,
    attention-weighted messages in the same layout (before
    ``out_project``)."""
    cfg = layer.cfg
    devs = _entry_devices(mesh)
    p_data, p_model = devs.shape
    n1 = h.shape[0] // p_data                 # n_loc + 1 (the dump row)
    if n1 * p_data != h.shape[0]:
        raise ValueError(f"{h.shape[0]} rows do not split into {p_data} "
                         f"blocks")
    src_b = torch.as_tensor(np.asarray(src_b) if not torch.is_tensor(src_b)
                            else src_b)
    dst_b = torch.as_tensor(np.asarray(dst_b) if not torch.is_tensor(dst_b)
                            else dst_b)
    pos = pos.to(h.dtype)
    # the reference's float32 accumulators, wider for a float64 forward
    acc = torch.promote_types(h.dtype, torch.float32)
    messages = {dev: _messages_on(layer, dev) for dev in mesh.distinct_devices}

    def block(x, d, dev):
        return x[d * n1:(d + 1) * n1].to(dev)

    def buckets(d, m, s, dev):
        return (src_b[d, m, s].to(dev, torch.int64),
                dst_b[d, m, s].to(dev, torch.int64))

    # phase 1: the streaming max of the logits, without gradient
    maxima = {}
    with torch.no_grad():
        for d in range(p_data):
            for m in range(p_model):
                dev = devs[d, m]
                x_in, p_in = block(h, d, dev), block(pos, d, dev)
                mx = torch.full((n1, cfg.n_heads), -1e30, dtype=acc,
                                device=dev)
                for s in range(p_data):
                    sd = _source_block(d, s, p_data)
                    x_blk, p_blk = block(h, sd, dev), block(pos, sd, dev)
                    src, dst = buckets(d, m, s, dev)
                    rel = p_in[dst] - p_blk[src]
                    _, alpha = messages[dev](x_blk[src], x_in[dst], rel)
                    alpha = torch.where((src < n1 - 1)[:, None], alpha, -1e30)
                    blk_max = agg_max(alpha, dst, n1)
                    mx = torch.maximum(mx, torch.nan_to_num(
                        blk_max, neginf=-1e30).to(acc))
                maxima[d, m] = mx
    shift = {}
    for d in range(p_data):
        top = _pmax([maxima[d, m] for m in range(p_model)], devs[d, 0])
        for m in range(p_model):
            shift[d, m] = top.to(devs[d, m])
    del maxima

    # phase 2: numerators and denominators, each step rematerialised
    def step(x_blk, x_in, p_blk, p_in, mx, src, dst, fn):
        rel = p_in[dst] - p_blk[src]
        msg, alpha = fn(x_blk[src], x_in[dst], rel)
        live = (src < n1 - 1)[:, None]
        # mask before exp: exp(garbage - (-1e30)) = inf would poison the
        # gradient of a later select (inf * 0 = NaN)
        w = torch.exp(torch.where(live, alpha - mx[dst], -1e30))
        msg = head_weight(w, msg.to(acc), cfg)
        return agg_sum(msg, dst, n1), agg_sum(w, dst, n1)

    out = []
    hsz = cfg.d_hidden // cfg.n_heads
    for d in range(p_data):
        nums, dens = [], []
        for m in range(p_model):
            dev = devs[d, m]
            x_in, p_in = block(h, d, dev), block(pos, d, dev)
            num = torch.zeros((n1, cfg.d_hidden, cfg.comps), dtype=acc,
                              device=dev)
            den = torch.zeros((n1, cfg.n_heads), dtype=acc, device=dev)
            for s in range(p_data):
                sd = _source_block(d, s, p_data)
                src, dst = buckets(d, m, s, dev)
                dn, dd = torch.utils.checkpoint.checkpoint(
                    step, block(h, sd, dev), x_in, block(pos, sd, dev), p_in,
                    shift[d, m], src, dst, messages[dev],
                    use_reentrant=False)
                num = num + dn
                den = den + dd
            nums.append(num)
            dens.append(den)
        home = devs[d, 0]
        num = _psum(nums, home)
        den = torch.clamp(_psum(dens, home), min=1e-30)
        out.append((num / torch.repeat_interleave(den, hsz, dim=-1)[..., None]
                    ).to(h.dtype).to(h.device))
    return torch.cat(out)


# -------------------------------------------------------------------------
# Full ring forward
# -------------------------------------------------------------------------
def forward_ring(model, nodes: torch.Tensor, pos: torch.Tensor, src_b,
                 dst_b, mesh) -> torch.Tensor:
    """The port's ``EquiformerV2`` over the ring: ``nodes`` [p_data *
    (n_loc + 1), F] and ``pos`` likewise (:func:`blocked_layout`: each
    block carries its own dump row, so block-local pads hit block-local
    rows), on the model's device.  Returns the node irreps in the same
    layout (:func:`unblock` takes the real rows)."""
    cfg = model.cfg
    h0 = model.embed(nodes.to(cfg.dtype))
    x = h0.new_zeros((nodes.shape[0], cfg.d_hidden, cfg.comps))
    x[..., 0] = h0
    for layer in model.layers:
        h = IR.equivariant_rms_norm(cfg.l_max, x, layer.norm1)
        agg = ring_attention(layer, h, pos, src_b, dst_b, mesh)
        x = x + out_project(layer.out, agg, cfg)
        h = IR.equivariant_rms_norm(cfg.l_max, x, layer.norm2)
        x = x + layer.ffn(h)
    return x


__all__ = ["blocked_layout", "bucket_edges", "bucket_specs", "forward_ring",
           "ring_attention", "unblock"]
