"""Attention for the LM (port of ``repro.models.attention``): RoPE,
GQA (qwen2, phi3) and MLA (deepseek-v2), each with the plain causal
path, blockwise prefill and one-token decode against the cache.

Query heads are padded to a multiple of ``cfg.tp`` as the configuration
says (``tp = 1`` keeps the published count).  The projections take
their head count from the weights they are given: all of them, or, on
the tensor-parallel path, one ``model`` entry's columns of ``wq`` /
``bq`` / ``wuq`` / ``wuk`` / ``wuv`` and rows of ``wo``, whose output is
that entry's partial sum (``prefill_tp``, ``gqa_decode_tp``,
``mla_decode_tp``, and under FSDP training ``train_tp`` on each entry's
gathered view; the sums in entry order, ``launch.mesh.psum``).

Two places differ from the reference on purpose, and say so below:
decode writes the new cache rows in place (K and V for GQA, the latent
``ckv`` and the rope key ``kr`` for MLA), and the blockwise prefill
slices the true tail block (the reference clamps the last block's
start and masks it by the unclamped positions, which is wrong when t is
not a multiple of ``block_k``).  GQA decode attention runs on the
flash_decode kernel; MLA decode is the reference's absorbed einsums
(one latent head with keys of kv_lora + rope width and values of
kv_lora width, outside any kernel in the reference too).

Against a cache laid out over a mesh (``transformer.init_cache(...,
mesh=)``), ``gqa_decode_sharded`` and ``mla_decode_sharded`` attend over
each sequence shard on its own device and merge the shards by their
log-sum-exps (``merge_by_lse``): the reference's sequence-sharded decode,
whose merge XLA derives from ``cache_specs``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.kernels.flash_decode.ops import decode_attention
from repro_torch.launch.mesh import (all_gather, alike, collect, each_entry,
                                     each_row, psum, working)
from repro_torch.models.common import dense_init, init_rms, rms_norm


# -------------------------------------------------------------------------
# RoPE
# -------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions int [...] -> (cos, sin) float64 [..., dim/2].

    Float64 as in the reference, where x64 is on and the inverse
    frequencies are a float64 numpy array."""
    ang = positions.to(torch.float32).to(torch.float64)[..., None] * \
        _inv_freq(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's float64 inverse frequencies, copied to ``device``
    once (a copy from host memory per decode step would wait for the
    card)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
    return torch.from_numpy(inv).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., dim]; rotate-half convention; cos/sin broadcast
    [..., dim/2].  Computed in the tables' float64, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def pad_heads(n_heads: int, multiple: int) -> int:
    return int(-(-n_heads // multiple) * multiple)


# -------------------------------------------------------------------------
# GQA
# -------------------------------------------------------------------------
def init_gqa(cfg, *, generator: torch.Generator, device="cuda",
             lead: tuple = ()) -> dict:
    """wq [d, hq * dh], wk, wv [d, kv * dh], wo [hq * dh, d] (and zero
    biases with ``cfg.qkv_bias``), each with ``lead`` leading axes."""
    device = resolve_device(device)
    d, hq = cfg.d_model, cfg.padded_heads
    kv, dh = cfg.n_kv_heads, cfg.d_head
    kw = dict(generator=generator, dtype=cfg.param_dtype, device=device,
              lead=lead)
    p = {"wq": dense_init(d, hq * dh, **kw),
         "wk": dense_init(d, kv * dh, **kw),
         "wv": dense_init(d, kv * dh, **kw),
         "wo": dense_init(hq * dh, d, **kw)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((*lead, width), dtype=cfg.param_dtype,
                                  device=device)
    return p


def gqa_specs(cfg) -> dict:
    """The logical specs of :func:`init_gqa`'s tree (the reference's
    ``init_gqa`` returns them beside the weights)."""
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        s["bq"], s["bk"], s["bv"] = ("heads",), ("kv_heads",), ("kv_heads",)
    return s


def _gqa_q(p, x, cfg, cos, sin):
    """q [b, t, h, dh] of the query heads ``p["wq"]`` holds (all of them,
    or one entry's under tensor parallelism), rotated by (cos, sin)."""
    b, t, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, t, -1, cfg.d_head)
    return apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])


def _gqa_kv(p, x, cfg, cos, sin):
    """k (rotated) and v [b, t, kv, dh]."""
    b, t, _ = x.shape
    kv, dh = cfg.n_kv_heads, cfg.d_head
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = apply_rope(k.reshape(b, t, kv, dh), cos[:, :, None, :],
                   sin[:, :, None, :])
    return k, v.reshape(b, t, kv, dh)


def _proj_qkv_gqa(p, x, cfg, positions):
    """q [b, t, h, dh] (:func:`_gqa_q`), k and v [b, t, kv, dh]."""
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    return (_gqa_q(p, x, cfg, cos, sin),) + _gqa_kv(p, x, cfg, cos, sin)


def _expand_kv(x: torch.Tensor, cfg, head0: int = 0,
               n: int | None = None) -> torch.Tensor:
    """[b, t, kv, dh] -> [b, t, n, dh] for the query heads [head0, head0
    + n) (default: all ``cfg.padded_heads``): query head h reads KV head
    h // ceil(hq / kv) (``jnp.repeat`` over the head axis)."""
    hq, kv = cfg.padded_heads, cfg.n_kv_heads
    n = hq - head0 if n is None else n
    return x.repeat_interleave(-(-hq // kv), dim=2)[:, :, head0:head0 + n]


def gqa_train(p, x, cfg, positions, head0: int = 0):
    """Causal self-attention over the full sequence (the plain prefill
    core): ``[b, h, t, t]`` scores, fp32 softmax.  Under tensor
    parallelism ``p`` holds one entry's heads, the first of them
    ``head0``, and the output is that entry's partial sum (module doc).
    Returns (out [b, t, d], (k, v) [b, t, kv, dh])."""
    b, t, _ = x.shape
    dh = cfg.d_head
    q, k, v = _proj_qkv_gqa(p, x, cfg, positions)
    hq = q.shape[2]
    k_full = _expand_kv(k, cfg, head0, hq)
    v_full = _expand_kv(v, cfg, head0, hq)
    scores = torch.einsum("bthd,bshd->bhts", q, k_full) / float(np.sqrt(dh))
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v_full).reshape(b, t, hq * dh)
    return ctx @ p["wo"], (k, v)


def gqa_decode(p, x, cache_k, cache_v, lengths, cfg):
    """One-token decode against the cache.

    x [b, 1, d]; cache_k, cache_v [b, S, kv, dh]; lengths int32 [b], the
    valid length before this token.  The new K and V rows are written
    **in place** into ``cache_k`` and ``cache_v`` at ``lengths`` (the
    reference returns updated copies; at serving size a copy per step is
    out of the question), clamped to S - 1 as the reference's
    ``dynamic_update_slice`` clamps.  Attention runs through
    :func:`decode_attention` (the flash_decode kernel on the card) over
    positions ``<= lengths``, the new token included.  Returns
    (out [b, 1, d], cache_k, cache_v)."""
    b = x.shape[0]
    hq, kv, dh = cfg.padded_heads, cfg.n_kv_heads, cfg.d_head
    positions = lengths[:, None]
    q, k_new, v_new = _proj_qkv_gqa(p, x, cfg, positions)
    rows = torch.arange(b, device=x.device)
    at = lengths.long().clamp(0, cache_k.shape[1] - 1)
    cache_k[rows, at] = k_new[:, 0]
    cache_v[rows, at] = v_new[:, 0]
    # pad q up to kv * ceil(hq / kv) heads so that head counts that do
    # not divide (phi3: 48 padded q heads, 10 kv) work
    group = -(-hq // kv)
    hq_pad = kv * group
    q = q.reshape(b, hq, dh)
    if hq_pad != hq:
        q = torch.cat([q, q.new_zeros((b, hq_pad - hq, dh))], dim=1)
    ctx = decode_attention(q, cache_k, cache_v, lengths + 1)
    ctx = ctx.reshape(b, 1, hq_pad * dh)[..., :hq * dh]
    return ctx @ p["wo"], cache_k, cache_v


# -------------------------------------------------------------------------
# The sequence-sharded decode: a cache laid out over a mesh
# -------------------------------------------------------------------------
def _cache_blocks(cache) -> list:
    """A placed ``[L, b, S, ...]`` cache's blocks as ``(key, (b0, b1),
    (s0, s1), shard, entry)``, each block once in mesh order with the
    first entry that holds it; only the batch and sequence axes may be
    split (``cache_specs``)."""
    if any(p != 1 for i, p in enumerate(cache.parts) if i not in (1, 2)):
        raise ValueError(f"a decode cache splits only its batch and "
                         f"sequence axes, got {cache.sharding.spec}")
    first = {}
    for e, key in enumerate(cache.entry_keys):
        first.setdefault(key, e)
    return [(key, bounds[1], bounds[2], t, first[key])
            for key, bounds, t in cache.blocks]


def cache_fill(cache, layer: int, rows: torch.Tensor) -> None:
    """Write ``rows`` [b, t, ...] into positions [0, t) of layer
    ``layer`` of a placed cache: into every shard (every copy) whose
    range they reach."""
    t = rows.shape[1]
    for (block, dev), shard in cache.shards.items():
        (b0, b1), (s0, s1) = cache.bounds(block)[1:3]
        hi = min(s1, t)
        if b1 > b0 and hi > s0:
            shard[layer, :, :hi - s0] = rows[b0:b1, s0:hi].to(dev)


def cache_write(cache, layer: int, new: torch.Tensor,
                at: torch.Tensor) -> None:
    """Write ``new`` [b, ...] at positions ``at`` [b] of layer ``layer``
    of a placed cache, into the shard (each copy of it) whose range
    holds the position; the other shards keep their rows (each rewrites
    its own value).  No host sync.  Each shard's write is the work of
    the entries holding it (alike shards once in a dry run:
    ``launch.mesh.alike``)."""
    holders: dict = {}
    for e, key in enumerate(cache.entry_keys):
        holders.setdefault(key, []).append(e)
    keys = list(cache.shards)
    bounds = [cache.bounds(key[0])[1:3] for key in keys]
    for i, same in alike([(b1 - b0, s1 - s0) for (b0, b1), (s0, s1)
                          in bounds]):
        (b0, b1), (s0, s1) = bounds[i]
        if b1 == b0 or s1 == s0:
            continue
        dev, shard = keys[i][1], cache.shards[keys[i]]
        with working([e for j in same for e in holders[keys[j]]]):
            a = at[b0:b1].to(dev)
            hit = ((a >= s0) & (a < s1)).view(-1, *([1] * (new.dim() - 1)))
            idx = (a - s0).clamp(0, s1 - s0 - 1)
            rows = torch.arange(b1 - b0, device=dev)
            part = shard[layer]
            part[rows, idx] = torch.where(hit, new[b0:b1].to(dev),
                                          part[rows, idx])


def merge_by_lse(parts, out_dtype) -> torch.Tensor:
    """Partial attention outputs ``[(out_i [b, h, d], lse_i [b, h])]``
    over disjoint position ranges, merged in list order into the softmax
    over their union: ``lse = logsumexp_i lse_i``, ``out = sum_i
    exp(lse_i - lse) out_i`` in float32.  A part whose range held no
    valid position (``lse_i = -inf``) weighs 0; rows without any give
    zeros, never NaN."""
    lse = torch.logsumexp(torch.stack([l for _, l in parts]), dim=0)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    out = 0
    for o, l in parts:
        out = out + torch.exp(l - lse)[..., None] * o.float()
    return out.to(out_dtype)


def _batch_merge(parts_by_rows: dict, b: int, dtype,
                 device) -> torch.Tensor:
    """Each batch range's parts, brought to ``device`` (the shards' moves
    charged as the merge's: ``launch.mesh.collect``), merged by
    :func:`merge_by_lse`, the ranges laid side by side into [b, ...]
    (alike ranges merged once in a dry run)."""
    collect("merge", "all-gather", [x for parts in parts_by_rows.values()
                                    for pair in parts for x in pair])
    ranges = list(parts_by_rows)
    out = None
    for i, same in alike([(b1 - b0, len(parts_by_rows[(b0, b1)]))
                          for b0, b1 in ranges]):
        with working(0, len(same)):
            merged = merge_by_lse([(o.to(device), lse.to(device)) for o, lse
                                   in parts_by_rows[ranges[i]]], dtype)
        if out is None:
            out = merged.new_zeros((b,) + tuple(merged.shape[1:]))
        for j in same:
            b0, b1 = ranges[j]
            out[b0:b1] = merged
    return out


def _shard_parts(blocks, fn) -> dict:
    """``{(b0, b1): [fn(key, b0, b1, s0, s1, shard), ...]}`` over a
    placed cache's blocks (:func:`_cache_blocks`) in order, each call the
    work of the block's entry (alike blocks once in a dry run:
    ``launch.mesh.alike``)."""
    live = [blk for blk in blocks if blk[1][1] > blk[1][0] and
            blk[2][1] > blk[2][0]]
    parts: dict = {}
    got = [None] * len(live)
    for i, same in alike([(b1 - b0, s1 - s0) for _, (b0, b1), (s0, s1), _, _
                          in live]):
        key, (b0, b1), (s0, s1), shard, _ = live[i]
        with working([live[j][4] for j in same]):
            out = fn(key, b0, b1, s0, s1, shard)
        for j in same:
            got[j] = out
    for blk, out in zip(live, got):
        parts.setdefault(blk[1], []).append(out)
    return parts


def _pad_group(q: torch.Tensor, cfg) -> torch.Tensor:
    """q [b, hq, dh] padded with zero heads up to kv * ceil(hq / kv), so
    that head counts that do not divide (phi3: 48 padded q heads, 10 kv)
    work."""
    hq, kv = cfg.padded_heads, cfg.n_kv_heads
    hq_pad = kv * -(-hq // kv)
    if hq_pad == hq:
        return q
    return torch.cat([q, q.new_zeros((q.shape[0], hq_pad - hq,
                                      q.shape[2]))], dim=1)


def gqa_cache_attend(q, k_new, v_new, cache_k, cache_v, layer: int,
                     lengths, cfg) -> torch.Tensor:
    """The sequence-sharded decode's attention on layer ``layer`` of a
    placed cache (``repro_torch.launch.mesh.Placed`` k and v, ``[L, b,
    S, kv, dh]`` split over the sequence, and the batch where the rules
    say so): q [b, hq, dh] and the new rows k_new, v_new [b, kv, dh] on
    the controller's device -> the context [b, 1, hq * dh] there.

    The new K and V rows go only into the shard that holds position
    ``lengths[b]`` (clamped to S - 1, as on one device).  Each shard
    runs :func:`decode_attention` -- the flash_decode kernel on a card,
    one launch a shard -- on its own device over its local lengths
    ``clamp(lengths + 1 - lo, 0, hi - lo)``, returning its output and
    log-sum-exp; the parts are merged on q's device in shard order
    (:func:`merge_by_lse`).  A shard past every row's length launches
    all the same and weighs 0; a shard of no positions (``s_max`` split
    unevenly) is skipped."""
    b = q.shape[0]
    hq, dh = cfg.padded_heads, cfg.d_head
    at = lengths.long().clamp(0, cache_k.shape[2] - 1)
    cache_write(cache_k, layer, k_new, at)
    cache_write(cache_v, layer, v_new, at)
    q = _pad_group(q, cfg)
    ends = lengths.to(torch.int64) + 1
    def attend(key, b0, b1, s0, s1, kt):
        dev = key[1]
        local = (ends[b0:b1].to(dev) - s0).clamp(0, s1 - s0)
        return decode_attention(q[b0:b1].to(dev), kt[layer],
                                cache_v.shards[key][layer],
                                local.to(torch.int32), return_lse=True)
    ctx = _batch_merge(_shard_parts(_cache_blocks(cache_k), attend), b,
                       q.dtype, q.device)
    return ctx.reshape(b, 1, -1)[..., :hq * dh]


def gqa_decode_sharded(p, x, cache_k, cache_v, layer: int, lengths, cfg):
    """:func:`gqa_decode` against layer ``layer`` of a placed cache
    (:func:`gqa_cache_attend`).  Returns out [b, 1, d]."""
    b = x.shape[0]
    q, k_new, v_new = _proj_qkv_gqa(p, x, cfg, lengths[:, None])
    ctx = gqa_cache_attend(q.reshape(b, -1, cfg.d_head), k_new[:, 0],
                           v_new[:, 0], cache_k, cache_v, layer, lengths,
                           cfg)
    return ctx @ p["wo"]


def _mla_absorbed_q(p, x, cfg, positions):
    """The absorbed decode's query: (q_lat [b, h, cl], q_rope [b, h,
    dr]) for the heads ``p`` holds (W_uk folded into q_nope)."""
    h, dn, cl = _mla_heads(p, cfg), cfg.qk_nope_dim, cfg.kv_lora
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0],
                         p["wuk"].reshape(cl, h, dn))
    return q_lat, q_rope[:, 0]


def _mla_absorbed_out(p, ctx_lat, cfg) -> torch.Tensor:
    """The latent context [b, h, cl] of the heads ``p`` holds through
    W_uv and ``wo``: out [b, 1, d] (one entry's partial sum under tensor
    parallelism)."""
    b, h = ctx_lat.shape[:2]
    ctx = torch.einsum("bhc,chd->bhd", ctx_lat,
                       p["wuv"].reshape(cfg.kv_lora, h, cfg.v_head_dim))
    return ctx.reshape(b, 1, -1) @ p["wo"]


def mla_cache_attend(q_lat, q_rope, ckv_new, kr_new, cache_ckv, cache_kr,
                     layer: int, lengths, cfg) -> torch.Tensor:
    """:func:`gqa_cache_attend` for MLA: q_lat [b, h, cl], q_rope [b, h,
    dr] and the new rows ckv_new [b, cl], kr_new [b, dr] on the
    controller's device, a placed latent cache (``ckv [L, b, S, cl]``
    and ``kr [L, b, S, dr]``) -> the latent context [b, h, cl] there.
    The absorbed einsums over each shard on its device (plain torch: the
    reference has no MLA kernel), each giving its latent context under
    its own softmax and the log-sum-exp of its masked scores, merged in
    shard order."""
    b = q_lat.shape[0]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    at = lengths.long().clamp(0, cache_ckv.shape[2] - 1)
    cache_write(cache_ckv, layer, ckv_new, at)
    cache_write(cache_kr, layer, kr_new, at)
    scale = float(np.sqrt(dn + dr))
    def attend(key, b0, b1, s0, s1, ct):
        dev = key[1]
        c, r = ct[layer], cache_kr.shards[key][layer]
        scores = (torch.einsum("bhc,bsc->bhs", q_lat[b0:b1].to(dev), c) +
                  torch.einsum("bhd,bsd->bhs", q_rope[b0:b1].to(dev), r))
        scores = scores / scale
        valid = s0 + torch.arange(s1 - s0, device=dev) <= \
            lengths[b0:b1, None].to(dev)
        scores = torch.where(valid[:, None], scores.float(), -1e30)
        lse = torch.logsumexp(scores, dim=-1)
        probs = torch.exp(scores - lse[..., None]).to(q_lat.dtype)
        return torch.einsum("bhs,bsc->bhc", probs, c), lse
    return _batch_merge(_shard_parts(_cache_blocks(cache_ckv), attend), b,
                        q_lat.dtype, q_lat.device)


def mla_decode_sharded(p, x, cache_ckv, cache_kr, layer: int, lengths, cfg):
    """:func:`mla_decode` against layer ``layer`` of a placed latent
    cache (:func:`mla_cache_attend`).  Returns out [b, 1, d]."""
    positions = lengths[:, None]
    q_lat, q_rope = _mla_absorbed_q(p, x, cfg, positions)
    ckv_new, kr_new = _mla_ckv(p, x, cfg, positions)
    ctx_lat = mla_cache_attend(q_lat, q_rope, ckv_new[:, 0], kr_new[:, 0],
                               cache_ckv, cache_kr, layer, lengths, cfg)
    return _mla_absorbed_out(p, ctx_lat, cfg)


# -------------------------------------------------------------------------
# Tensor parallelism: the query heads split over the mesh's model axis
# -------------------------------------------------------------------------
def _head0(groups, cfg, i: int) -> int:
    """The first query head the ``i``-th entry of a group holds (its heads
    a contiguous range in model order)."""
    return i * (cfg.padded_heads // len(groups[0][2]))


def prefill_tp(groups, x, cfg, positions, attn_fn):
    """A layer's attention over split heads: ``groups`` ``[(b0, b1,
    [(dev, p, e), ...]), ...]`` -- each batch range [b0, b1) (``batch`` ->
    ``data``) with its ``model`` entries in order, ``p`` entry ``e``'s
    layer-local attention weights (``wq`` / ``bq`` / ``wuq`` / ``wuk``
    / ``wuv`` by column, ``wo`` by row, the rest whole) -- and the normed
    residual ``x`` [b, t, d] on the controller's device.  Each entry runs
    ``attn_fn`` (the plain or blockwise prefill) for its heads on its
    device and multiplies by its ``wo`` rows (``launch.mesh.each_entry``);
    the partial outputs are summed in entry order on ``x``'s device.
    Returns (out [b, t, d], the two cache tensors of the first entry of
    each range, joined over the batch on ``x``'s device)."""
    def row(_, b0, b1, ents):
        def run(i, dev, p, e):
            kw = {} if cfg.attn == "mla" else dict(
                head0=_head0(groups, cfg, i))
            return attn_fn(p, x[b0:b1].to(dev), cfg,
                           positions[b0:b1].to(dev), **kw)
        got = each_entry(ents, run)
        c1, c2 = got[0][1]
        return (psum([out for out, _ in got], x.device), c1.to(x.device),
                c2.to(x.device))
    outs, c1s, c2s = zip(*each_row(groups, row))
    return torch.cat(outs), (torch.cat(c1s), torch.cat(c2s))


def train_tp(groups, x, cfg, positions):
    """The training attention over split heads (``groups`` and ``x`` as
    :func:`prefill_tp` takes them; under FSDP ``p`` is an entry's
    gathered view of the layer, ``launch.mesh.entry_view``): each entry
    runs :func:`gqa_train` (from its first head) or :func:`mla_train` on
    its heads, differentiable, and the entries' partial outputs are
    summed in entry order on ``x``'s device (``launch.mesh.psum``).  No
    cache is kept.  Returns out [b, t, d]."""
    attn = mla_train if cfg.attn == "mla" else gqa_train

    def row(_, b0, b1, ents):
        def run(i, dev, p, e):
            kw = {} if cfg.attn == "mla" else dict(
                head0=_head0(groups, cfg, i))
            return attn(p, x[b0:b1].to(dev), cfg, positions[b0:b1].to(dev),
                        **kw)[0]
        return psum(each_entry(ents, run), x.device)
    return torch.cat(each_row(groups, row))


def gqa_decode_tp(groups, x, cache_k, cache_v, layer: int, lengths, cfg):
    """The sequence-sharded decode over split heads (``groups`` and ``x``
    [b, 1, d] as :func:`prefill_tp` takes them): each entry projects q
    for its heads; the heads are gathered on ``x``'s device ([b, hq,
    dh]) beside the new K and V rows (the first entry's: ``wk`` / ``wv``
    are whole); :func:`gqa_cache_attend` runs flash_decode a cache shard
    and merges the shards by their log-sum-exps; each entry multiplies
    its heads' slice of the context by its ``wo`` rows, and the partial
    outputs are summed.  Returns out [b, 1, d]."""
    dh = cfg.d_head

    def project_row(_, b0, b1, ents):
        def project(i, dev, p, e):
            h = x[b0:b1].to(dev)
            cos, sin = rope_tables(lengths[b0:b1, None].to(dev), dh,
                                   cfg.rope_theta)
            q = _gqa_q(p, h, cfg, cos, sin)[:, 0]
            return (q, _gqa_kv(p, h, cfg, cos, sin)) if i == 0 else (q, None)
        got = each_entry(ents, project)
        k, v = got[0][1]
        return (all_gather([q for q, _ in got], 1, x.device),
                k[:, 0].to(x.device), v[:, 0].to(x.device))
    qs, ks, vs = zip(*each_row(groups, project_row))
    ctx = gqa_cache_attend(torch.cat(qs), torch.cat(ks), torch.cat(vs),
                           cache_k, cache_v, layer, lengths, cfg)

    def out_row(_, b0, b1, ents):
        def out(i, dev, p, e):
            head0, n = _head0(groups, cfg, i), p["wo"].shape[0]
            return ctx[b0:b1, :, head0 * dh:head0 * dh + n].to(dev) @ p["wo"]
        return psum(each_entry(ents, out), x.device)
    return torch.cat(each_row(groups, out_row))


def mla_decode_tp(groups, x, cache_ckv, cache_kr, layer: int, lengths, cfg):
    """:func:`gqa_decode_tp` for MLA: each entry's absorbed query
    (``wuq`` / ``wuk`` columns of its heads), the latent queries gathered
    over the heads, :func:`mla_cache_attend` over the cache shards, then
    each entry's heads of the latent context through its ``wuv``
    columns and ``wo`` rows, the partial outputs summed."""
    def project_row(_, b0, b1, ents):
        def project(i, dev, p, e):
            h, pos = x[b0:b1].to(dev), lengths[b0:b1, None].to(dev)
            q = _mla_absorbed_q(p, h, cfg, pos)
            return (q, _mla_ckv(p, h, cfg, pos)) if i == 0 else (q, None)
        got = each_entry(ents, project)
        ckv, kr = got[0][1]
        return (all_gather([q[0] for q, _ in got], 1, x.device),
                all_gather([q[1] for q, _ in got], 1, x.device),
                ckv[:, 0].to(x.device), kr[:, 0].to(x.device))
    qls, qrs, cs, rs = zip(*each_row(groups, project_row))
    ctx_lat = mla_cache_attend(torch.cat(qls), torch.cat(qrs), torch.cat(cs),
                               torch.cat(rs), cache_ckv, cache_kr, layer,
                               lengths, cfg)

    def out_row(_, b0, b1, ents):
        def out(i, dev, p, e):
            head0, h = _head0(groups, cfg, i), _mla_heads(p, cfg)
            return _mla_absorbed_out(
                p, ctx_lat[b0:b1, head0:head0 + h].to(dev), cfg)
        return psum(each_entry(ents, out), x.device)
    return torch.cat(each_row(groups, out_row))


# -------------------------------------------------------------------------
# Blockwise (flash-style) attention for long prefill.
# -------------------------------------------------------------------------
def blockwise_attention(q, make_kv_block, t_kv: int, block_k: int,
                        scale: float, q_positions, d_v: int | None = None,
                        q_last=None):
    """q [b, h, t, dh]; ``make_kv_block(start)`` -> (k [b, n, h, dh],
    v [b, n, h, d_v]; ``d_v`` defaults to dh) for the true block
    ``[start, min(start + block_k, t_kv))``; causal mask by absolute
    positions (key ``start + j`` is
    seen by queries with ``q_positions >= start + j``).  ``q_positions``
    must not decrease along t, as prefill's do.  ``q_last``: each
    query's largest position over the batch on the host, where the
    caller knows them (a prefill's are 0..t-1); else they are read from
    ``q_positions``, one host read a block.

    Keys and values stream through in blocks with the online-softmax
    recurrence, in float32.  The rows whose queries all precede a block
    are left out of it: the reference's arithmetic adds exactly 0 to
    them and rescales them by exactly 1, so no number changes, and a
    causal prefill does about half the reference's work.
    Returns [b, h, t, d_v] float32."""
    b, h, t, dh = q.shape
    q32 = q.float()
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, d_v or dh), device=q.device)
    last = q_positions.amax(dim=0).contiguous() if q_last is None \
        else np.asarray(q_last)                       # [t], sorted
    for start in range(0, t_kv, block_k):
        lo = int(torch.searchsorted(last, start) if q_last is None else
                 np.searchsorted(last, start))
        if lo == t:
            continue
        k_blk, v_blk = make_kv_block(start)
        n = k_blk.shape[1]
        kt = k_blk.float().transpose(1, 2)                  # [b, h, n, dh]
        s = torch.einsum("bhtd,bhsd->bhts", q32[:, :, lo:], kt) * scale
        kpos = start + torch.arange(n, device=q.device)
        s.masked_fill_(q_positions[:, None, lo:, None] < kpos, -1e30)
        m_old = m[:, :, lo:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m_old - m_new)
        l[:, :, lo:] = l[:, :, lo:] * corr + p.sum(dim=-1)
        pv = torch.einsum("bhts,bshd->bhtd", p, v_blk.float())
        acc[:, :, lo:] = acc[:, :, lo:] * corr[..., None] + pv
        m[:, :, lo:] = m_new
    return acc / l.clamp(min=1e-30)[..., None]


def gqa_prefill_blockwise(p, x, cfg, positions, block_k: int = 1024,
                          head0: int = 0, q_last=None):
    """GQA prefill with blockwise attention (``head0`` as in
    :func:`gqa_train`, ``q_last`` as :func:`blockwise_attention` takes
    it); returns (out, (k, v))."""
    b, t, _ = x.shape
    dh = cfg.d_head
    q, k, v = _proj_qkv_gqa(p, x, cfg, positions)
    hq = q.shape[2]

    def kv_block(start):
        return (_expand_kv(k[:, start:start + block_k], cfg, head0, hq),
                _expand_kv(v[:, start:start + block_k], cfg, head0, hq))

    ctx = blockwise_attention(q.transpose(1, 2), kv_block, t, block_k,
                              1.0 / math.sqrt(dh), positions, q_last=q_last)
    ctx = ctx.transpose(1, 2).to(x.dtype).reshape(b, t, hq * dh)
    return ctx @ p["wo"], (k, v)


def mla_prefill_blockwise(p, x, cfg, positions, block_k: int = 1024,
                          q_last=None):
    """MLA prefill with blockwise attention: the rope part rides in
    extended head dims (q_ext = [q_nope, q_rope], k_ext = [k_nope, k_rope
    on every head]), and k_nope and v are expanded from the latent cache
    one block at a time, never at full length.  Returns (out, (ckv,
    k_rope))."""
    b, t, _ = x.shape
    h, dn, dr, dv = (_mla_heads(p, cfg), cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)        # [b, t, h, .]
    ckv, k_rope = _mla_ckv(p, x, cfg, positions)         # [b, t, cl / dr]
    q_ext = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)

    def kv_block(start):
        ckv_blk = ckv[:, start:start + block_k]
        n = ckv_blk.shape[1]
        k_nope = (ckv_blk @ p["wuk"]).reshape(b, n, h, dn)
        kr = k_rope[:, start:start + block_k, None, :].expand(b, n, h, dr)
        return (torch.cat([k_nope, kr], dim=-1),
                (ckv_blk @ p["wuv"]).reshape(b, n, h, dv))

    ctx = blockwise_attention(q_ext, kv_block, t, block_k,
                              1.0 / math.sqrt(dn + dr), positions, d_v=dv,
                              q_last=q_last)
    ctx = ctx.transpose(1, 2).to(x.dtype).reshape(b, t, h * dv)
    return ctx @ p["wo"], (ckv, k_rope)


# -------------------------------------------------------------------------
# MLA (deepseek-v2)
# -------------------------------------------------------------------------
def init_mla(cfg, *, generator: torch.Generator, device="cuda",
             lead: tuple = ()) -> dict:
    """The reference's ``init_mla`` tree, each leaf with ``lead`` leading
    axes: with ``q_lora`` ``wdq [d, ql]``, ``q_norm [ql]``, ``wuq [ql,
    h (dn + dr)]``, else ``wq [d, h (dn + dr)]``; then ``wdkv [d, cl +
    dr]``, ``kv_norm [cl]``, ``wuk [cl, h dn]``, ``wuv [cl, h dv]``,
    ``wo [h dv, d]``."""
    device = resolve_device(device)
    d, h = cfg.d_model, cfg.padded_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cl, ql = cfg.kv_lora, cfg.q_lora
    kw = dict(generator=generator, dtype=cfg.param_dtype, device=device,
              lead=lead)

    def norm(width):
        return init_rms(width, dtype=cfg.param_dtype,
                        device=device).repeat(*lead, 1)

    p = {}
    if ql:
        p["wdq"] = dense_init(d, ql, **kw)
        p["q_norm"] = norm(ql)
        p["wuq"] = dense_init(ql, h * (dn + dr), **kw)
    else:
        p["wq"] = dense_init(d, h * (dn + dr), **kw)
    p["wdkv"] = dense_init(d, cl + dr, **kw)
    p["kv_norm"] = norm(cl)
    p["wuk"] = dense_init(cl, h * dn, **kw)
    p["wuv"] = dense_init(cl, h * dv, **kw)
    p["wo"] = dense_init(h * dv, d, **kw)
    return p


def mla_specs(cfg) -> dict:
    """The logical specs of :func:`init_mla`'s tree (the reference's
    ``init_mla`` returns them beside the weights)."""
    s = {}
    if cfg.q_lora:
        s["wdq"], s["q_norm"], s["wuq"] = ("embed", None), (None,), \
            (None, "heads")
    else:
        s["wq"] = ("embed", "heads")
    s.update(wdkv=("embed", None), kv_norm=(None,),
             wuk=("kv_lora", "heads"), wuv=("kv_lora", "heads"),
             wo=("heads", "embed"))
    return s


def _mla_heads(p, cfg) -> int:
    """The query heads ``p`` holds (all, or one entry's)."""
    return p["wuk"].shape[-1] // cfg.qk_nope_dim


def _mla_q(p, x, cfg, positions):
    b, t, _ = x.shape
    h, dn, dr = _mla_heads(p, cfg), cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora:
        q = rms_norm(p["q_norm"], x @ p["wdq"]) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, t, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[:, :, None, :], sin[:, :, None, :])
    return q_nope, q_rope


def _mla_ckv(p, x, cfg, positions):
    dr, cl = cfg.qk_rope_dim, cfg.kv_lora
    dkv = x @ p["wdkv"]
    ckv = rms_norm(p["kv_norm"], dkv[..., :cl])
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    return ckv, apply_rope(dkv[..., cl:], cos, sin)


def mla_train(p, x, cfg, positions):
    """Causal MLA over the full sequence (the plain prefill core):
    k_nope and v expanded from the latent, ``[b, h, t, t]`` scores,
    fp32 softmax.  Returns (out [b, t, d], (ckv [b, t, cl], k_rope
    [b, t, dr]))."""
    b, t, _ = x.shape
    h, dn, dr, dv = (_mla_heads(p, cfg), cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_ckv(p, x, cfg, positions)
    k_nope = (ckv @ p["wuk"]).reshape(b, t, h, dn)
    v = (ckv @ p["wuv"]).reshape(b, t, h, dv)
    scores = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope) +
              torch.einsum("bthd,bsd->bhts", q_rope, k_rope)) / float(
                  np.sqrt(dn + dr))
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, h * dv)
    return ctx @ p["wo"], (ckv, k_rope)


def mla_decode(p, x, cache_ckv, cache_kr, lengths, cfg):
    """One-token absorbed MLA decode: W_uk folds into the query and W_uv
    into the output, so scores and context live in the latent space and
    the cache is ``[S, kv_lora]`` + ``[S, rope]`` a request.  The
    reference's einsums, in its dtypes (scores in the activations'
    dtype, softmax in float32).

    x [b, 1, d]; cache_ckv [b, S, cl], cache_kr [b, S, dr]; lengths
    int32 [b], the valid length before this token.  The new rows are
    written **in place** at ``lengths`` (clamped to S - 1, as the
    reference's ``dynamic_update_slice`` clamps), as ``gqa_decode``
    does.  Returns (out [b, 1, d], cache_ckv, cache_kr)."""
    b = x.shape[0]
    h, dn, dr, dv, cl = (cfg.padded_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim, cfg.kv_lora)
    positions = lengths[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)      # [b, 1, h, .]
    ckv_new, kr_new = _mla_ckv(p, x, cfg, positions)   # [b, 1, cl / dr]
    rows = torch.arange(b, device=x.device)
    at = lengths.long().clamp(0, cache_ckv.shape[1] - 1)
    cache_ckv[rows, at] = ckv_new[:, 0]
    cache_kr[rows, at] = kr_new[:, 0]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0],
                         p["wuk"].reshape(cl, h, dn))      # absorb W_uk
    scores = (torch.einsum("bhc,bsc->bhs", q_lat, cache_ckv) +
              torch.einsum("bhd,bsd->bhs", q_rope[:, 0], cache_kr))
    scores = scores / float(np.sqrt(dn + dr))
    valid = torch.arange(cache_ckv.shape[1], device=x.device) <= \
        lengths[:, None]
    scores = torch.where(valid[:, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhs,bsc->bhc", probs, cache_ckv)
    ctx = torch.einsum("bhc,chd->bhd", ctx_lat,
                       p["wuv"].reshape(cl, h, dv)).reshape(b, 1, h * dv)
    return ctx @ p["wo"], cache_ckv, cache_kr
