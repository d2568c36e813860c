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

The node state is sharded everywhere, as the reference's is
(``P("data")``, replicated over ``model``): :func:`forward_ring` keeps
the blocked layout as a ``launch.mesh.Placed`` split over ``data`` --
block ``d`` on every entry (d, m) of its row, one copy a distinct
device -- and runs the embedding, both equivariant RMS norms,
``out_project`` and the FFN block by block on the blocks' devices (they
act node by node); :func:`ring_attention` takes and returns the blocks
where they lie.  No tensor of all nodes is made on the controller's
device; :func:`unblock` gathers the real rows where a caller wants them
whole.  Module weights reach another device than their own as
differentiable copies (:func:`_on`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.launch.mesh import (NamedSharding, PartitionSpec, Placed,
                                     alike, collapsing, count_move, place,
                                     quiet, working)
from repro_torch.models.gnn import irreps as IR
from repro_torch.models.gnn.equiformer_v2 import (edge_messages,
                                                  head_weight, out_project)
from repro_torch.models.gnn.graph import ModuleCall, agg_max, agg_sum, pmax


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
    of each block, in node order.  ``x`` whole, or placed over ``data``
    (:func:`forward_ring`'s output: the blocks gathered onto the first
    one's device)."""
    n_loc = -(-n_nodes // p_data)
    if isinstance(x, Placed):
        shards = [t for _, _, t in x.blocks]
        return torch.cat([t[:min((b + 1) * n_loc, n_nodes) - b * n_loc]
                          .to(shards[0].device)
                          for b, t in enumerate(shards)])
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


def _on(module: nn.Module, fn, dev: torch.device):
    """``fn(module, *args)`` computed on ``dev``: directly where the
    module lies, else through copies of its weights and buffers on
    ``dev`` (differentiable copies: the gradient reaches the module's own
    parameters)."""
    if next(module.parameters()).device == dev:
        return lambda *a: fn(module, *a)
    call = ModuleCall(module, fn)
    tensors = {n: t.to(dev) for n, t in
               list(call.named_parameters()) + list(call.named_buffers())}
    return lambda *a: torch.func.functional_call(call, tensors, a)


def _messages(layer, x_src, x_dst, rel):
    return edge_messages(layer, x_src, x_dst, rel, layer.cfg)


def _psum(parts, dev: torch.device) -> torch.Tensor:
    """The sum of the ``model`` entries' parts on ``dev``, in entry
    order."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _ring_moves(h: Placed, pos: Placed, p_data: int, p_model: int, n1: int,
                cfg, acc) -> None:
    """A dry run's charge for the moves of :func:`ring_attention` on
    every entry: at each step s > 0 of both phases entry (d, m) fetches
    block (d - s) mod p_data of ``h`` and ``pos`` from entry (that block,
    m); each row's maxima, numerators and denominators go from its
    entries to entry (d, 0), the shifts and the aggregate back."""
    blk = (h.shard(0).numel() * h.dtype.itemsize +
           pos.shard(0).numel() * pos.dtype.itemsize)
    d, m, s = np.meshgrid(np.arange(p_data), np.arange(p_model),
                          np.arange(1, p_data), indexing="ij")
    sd = (d - s) % p_data
    for _ in range(2):
        count_move("ring", "collective-permute", (sd * p_model + m).ravel(),
                   (d * p_model + m).ravel(), blk)
    d, m = np.meshgrid(np.arange(p_data), np.arange(1, p_model),
                       indexing="ij")
    entry, home = (d * p_model + m).ravel(), (d * p_model).ravel()
    size = torch.empty((), dtype=acc, device="meta").element_size()
    maxima = n1 * cfg.n_heads * size
    sums = n1 * (cfg.d_hidden * cfg.comps + cfg.n_heads) * size
    agg = n1 * cfg.d_hidden * cfg.comps * h.dtype.itemsize
    count_move("pmax", "all-reduce", entry, home, maxima)
    count_move("ring", "collective-permute", home, entry, maxima)
    count_move("psum", "all-reduce", entry, home, sums)
    count_move("ring", "collective-permute", home, entry, agg)


def _entry_devices(mesh):
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"the ring runs over a ('data', 'model') mesh, "
                         f"got {mesh.axis_names}")
    return mesh.devices


def _node_blocks(x, mesh) -> Placed:
    """``x`` [p_data * (n_loc + 1), ...] in the blocked layout as blocks
    over ``data`` (replicated over ``model``): as it is when already so
    placed, else cut (:func:`launch.mesh.place`)."""
    sharding = NamedSharding(mesh, PartitionSpec("data"))
    p_data = mesh.shape["data"]
    if x.shape[0] % p_data:
        raise ValueError(f"{x.shape[0]} rows do not split into {p_data} "
                         f"blocks")
    if isinstance(x, Placed):
        spec = tuple(x.sharding.spec)
        while spec and spec[-1] is None:       # ("data", None) == ("data",)
            spec = spec[:-1]
        if x.sharding.mesh != mesh or spec != ("data",):
            raise ValueError(f"node blocks must be placed by {sharding.spec} "
                             f"on {mesh}, got {x.sharding.spec}")
        return x
    return place(x, sharding)


def _nodewise(fn, first: Placed, *rest: Placed, shape=None) -> Placed:
    """``fn(device, shard, *shards)`` for each shard of ``first`` and the
    shards of ``rest`` at the same (block, device): a placed tensor of
    ``first``'s layout (node rows), of ``shape`` (default ``first``'s).
    Each shard's work is that of the entries holding it
    (``launch.mesh.working``; alike shards once in a dry run)."""
    holders: dict = {}
    for e, key in enumerate(first.entry_keys):
        holders.setdefault(key, []).append(e)
    keys = list(first.shards)
    shards = {}
    for i, same in alike([tuple(first.shards[k].shape) for k in keys]):
        key = keys[i]
        with working([e for j in same for e in holders[keys[j]]]):
            out = fn(key[1], first.shards[key],
                     *(r.shards[key] for r in rest))
        for j in same:
            shards[keys[j]] = out
    return Placed(first.sharding, shape or first.shape,
                  next(iter(shards.values())).dtype, shards,
                  first.entry_keys)


def _bucket(b, d: int, m: int, s: int, p_model: int) -> torch.Tensor:
    """Entry (d, m)'s bucket of ring step s: from its own shard of
    buckets placed over ``("data", "model")``, else from the whole
    array."""
    if isinstance(b, Placed):
        return b.shard(d * p_model + m)[0, 0, s]
    return b[d, m, s] if torch.is_tensor(b) else torch.from_numpy(
        np.asarray(b[d, m, s]))


def ring_attention(layer, h: Placed, pos: Placed, src_b, dst_b,
                   mesh) -> Placed:
    """One layer's ring attention (the reference's ``make_ring_attn``
    and ``_ring_attn_local``): ``h`` [p_data * (n_loc + 1), C, K] and
    ``pos`` [.., 3] in the blocked layout, placed over ``data``
    (:func:`forward_ring`), buckets (src, dst) [p_data, p_model, p_data,
    cap] (whole, or placed over ``("data", "model")``: each entry reads
    its own) -> the aggregated, attention-weighted messages (before
    ``out_project``), placed as ``h`` is.  Entry (d, m) reads its own
    copy of block d and fetches block ``(d - s) mod p_data`` from entry
    (that block, m) at step s."""
    cfg = layer.cfg
    devs = _entry_devices(mesh)
    p_data, p_model = devs.shape
    n1 = h.shape[0] // p_data                 # n_loc + 1 (the dump row)
    # the reference's float32 accumulators, wider for a float64 forward
    acc = torch.promote_types(h.dtype, torch.float32)
    messages = {dev: _on(layer, _messages, dev)
                for dev in mesh.distinct_devices}
    # a dry run on meta runs entry (0, 0)'s first step for every entry's
    # every step (they are alike: equal blocks, buckets padded to one
    # cap), and charges the ring's moves by formula (_ring_moves)
    dry = collapsing()
    rows, cols, steps = ((0,), (0,), (0,)) if dry else (
        range(p_data), range(p_model), range(p_data))
    every = range(p_data * p_model)

    def work(d, m, times=1):
        return working(every if dry else d * p_model + m, times)

    if dry:
        _ring_moves(h, pos, p_data, p_model, n1, cfg, acc)

    def block(x, d, m, dev):
        """Block d as entry (d, m) holds it, on ``dev``."""
        return x.shard(d * p_model + m).to(dev)

    def pos_block(d, m, dev):
        return block(pos, d, m, dev).to(h.dtype)

    def buckets(d, m, s, dev):
        return (_bucket(src_b, d, m, s, p_model).to(dev, torch.int64),
                _bucket(dst_b, d, m, s, p_model).to(dev, torch.int64))

    # phase 1: the streaming max of the logits, without gradient
    maxima = {}
    with torch.no_grad():
        for d in rows:
            for m in cols:
                dev = devs[d, m]
                with work(d, m):
                    x_in, p_in = block(h, d, m, dev), pos_block(d, m, dev)
                    mx = torch.full((n1, cfg.n_heads), -1e30, dtype=acc,
                                    device=dev)
                for s in steps:
                    sd = _source_block(d, s, p_data)
                    with work(d, m, p_data if dry else 1):
                        x_blk = block(h, sd, m, dev)
                        p_blk = pos_block(sd, m, dev)
                        src, dst = buckets(d, m, s, dev)
                        rel = p_in[dst] - p_blk[src]
                        _, alpha = messages[dev](x_blk[src], x_in[dst], rel)
                        alpha = torch.where((src < n1 - 1)[:, None], alpha,
                                            -1e30)
                        blk_max = agg_max(alpha, dst, n1)
                        mx = torch.maximum(mx, torch.nan_to_num(
                            blk_max, neginf=-1e30).to(acc))
                maxima[d, m] = mx
    shift = {}
    with quiet() if dry else contextlib.nullcontext():
        for d in rows:
            top = pmax([maxima[d, m] for m in cols], devs[d, 0])
            for m in cols:
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

    out = {}
    hsz = cfg.d_hidden // cfg.n_heads
    for d in rows:
        nums, dens = [], []
        for m in cols:
            dev = devs[d, m]
            with work(d, m):
                x_in, p_in = block(h, d, m, dev), pos_block(d, m, dev)
                num = torch.zeros((n1, cfg.d_hidden, cfg.comps), dtype=acc,
                                  device=dev)
                den = torch.zeros((n1, cfg.n_heads), dtype=acc, device=dev)
            for s in steps:
                sd = _source_block(d, s, p_data)
                with work(d, m, p_data if dry else 1):
                    src, dst = buckets(d, m, s, dev)
                    dn, dd = torch.utils.checkpoint.checkpoint(
                        step, block(h, sd, m, dev), x_in,
                        pos_block(sd, m, dev), p_in, shift[d, m], src, dst,
                        messages[dev], use_reentrant=False)
                    num = num + dn
                    den = den + dd
            nums.append(num)
            dens.append(den)
        home = devs[d, 0]
        with working(range(0, p_data * p_model, p_model) if dry else
                     d * p_model):
            num = _psum(nums, home)
            den = torch.clamp(_psum(dens, home), min=1e-30)
            out[d] = (num / torch.repeat_interleave(den, hsz, dim=-1)[
                ..., None]).to(h.dtype)
    if dry:
        out = {d: out[0] for d in range(p_data)}
    return Placed(h.sharding, h.shape, h.dtype,
                  {key: out[key[0][0]].to(key[1]) for key in h.shards},
                  h.entry_keys)


# -------------------------------------------------------------------------
# Full ring forward
# -------------------------------------------------------------------------
def _lift(embed, nodes, cfg):
    """The embedded scalars as degree-0 irreps [n, C, K]."""
    h0 = embed(nodes.to(cfg.dtype))
    x = h0.new_zeros((nodes.shape[0], cfg.d_hidden, cfg.comps))
    x[..., 0] = h0
    return x


def _norm1(layer, x):
    return IR.equivariant_rms_norm(layer.cfg.l_max, x, layer.norm1)


def _after_attention(layer, x, agg):
    """The rest of a layer once its attention is aggregated: the
    residual ``out_project``, the second norm and the FFN."""
    x = x + out_project(layer.out, agg, layer.cfg)
    return x + layer.ffn(IR.equivariant_rms_norm(layer.cfg.l_max, x,
                                                 layer.norm2))


def forward_ring(model, nodes, pos, src_b, dst_b, mesh) -> Placed:
    """The port's ``EquiformerV2`` over the ring: ``nodes`` [p_data *
    (n_loc + 1), F] and ``pos`` likewise (:func:`blocked_layout`: each
    block carries its own dump row, so block-local pads hit block-local
    rows), whole or already placed over ``data`` (module doc).  Returns
    the node irreps in the same layout, placed over ``data``
    (:func:`unblock` takes the real rows)."""
    cfg = model.cfg
    _entry_devices(mesh)
    nodes, pos = _node_blocks(nodes, mesh), _node_blocks(pos, mesh)
    devs = mesh.distinct_devices

    def on(module, fn):
        calls = {dev: _on(module, fn, dev) for dev in devs}
        return lambda dev, *a: calls[dev](*a)

    lift = on(model.embed, lambda emb, n: _lift(emb, n, cfg))
    x = _nodewise(lift, nodes, shape=(nodes.shape[0], cfg.d_hidden,
                                      cfg.comps))
    for layer in model.layers:
        h = _nodewise(on(layer, _norm1), x)
        agg = ring_attention(layer, h, pos, src_b, dst_b, mesh)
        x = _nodewise(on(layer, _after_attention), x, agg)
    return x


__all__ = ["blocked_layout", "bucket_edges", "bucket_specs", "forward_ring",
           "ring_attention", "unblock"]
