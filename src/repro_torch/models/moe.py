"""Feed-forward blocks of the LM (port of ``repro.models.moe``): the
dense SwiGLU FFN and the deepseek-v2 mixture of experts (shared + routed
top-k).

Dispatch is the reference's **sort-based, fixed-capacity** scheme, per
dispatch group: the ``n_tok = b * t`` tokens are cut into
``g = min(moe_groups, n_tok)`` groups (halved while g does not divide
n_tok), each expert takes at most ``cap = ceil(tg * k / e *
moe_capacity_factor)`` rows of a group of ``tg`` tokens, and the
overflow is dropped (its weight zeroed).  So ``moe_groups`` and
``moe_capacity_factor`` decide which tokens drop, on one card as on a
mesh.  On a mesh (:func:`moe_dispatch_tp`, and :func:`moe_ffn_tp` with
the aux loss for FSDP training) the routed experts are split over
``model`` and the buffer's rows over the batch ranges; routing and the
un-dispatch run whole, as on one card.  The shared experts run on the
layer's input as it is (``[b, t, d]``) on one card as on a mesh, so its
gradient adds the same two terms either way.

Routing keeps the reference's order exactly: a float32 router, softmax,
the top k with ties to the lower expert id (``lax.top_k``'s order), a
stable sort by expert and the rank within an expert from
``searchsorted(..., side="left")``.  The un-dispatch sums each token's
rows in the activations' dtype in the order the reference's ``.at[].add``
adds them (:func:`undispatch`), a gather and k - 1 adds, and no kernel
of the port (the reference's is its own jnp, not the segment_matmul
Pallas kernel).  Weights keep the
reference's [in, out] layout, experts stacked [E, in, out].
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import (collect, count_move, each_entry,
                                     each_row, psum)
from repro_torch.models.common import dense_init, swiglu


def init_dense_ffn(d: int, f: int, *, generator: torch.Generator,
                   dtype=torch.float32, device="cuda",
                   lead: tuple = ()) -> dict:
    """``{"w_gate", "w_up": [*lead, d, f], "w_down": [*lead, f, d]}``;
    ``lead`` stacks that many layers on leading axes."""
    kw = dict(generator=generator, dtype=dtype,
              device=resolve_device(device), lead=lead)
    return {"w_gate": dense_init(d, f, **kw), "w_up": dense_init(d, f, **kw),
            "w_down": dense_init(f, d, **kw)}


def dense_ffn_specs() -> dict:
    """The logical specs of :func:`init_dense_ffn`'s tree."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]


def _expert_stack(e: int, d_in: int, d_out: int, *, generator, dtype, device,
                  lead: tuple) -> torch.Tensor:
    """[*lead, e, d_in, d_out] drawn N(0, 1) / sqrt(d_in), one leading
    index at a time, so the float32 draw never holds more than one
    layer's experts."""
    out = torch.empty((*lead, e, d_in, d_out), dtype=dtype, device=device)
    for idx in np.ndindex(*lead):
        out[idx] = dense_init(d_in, d_out, generator=generator, dtype=dtype,
                              device=device, lead=(e,))
    return out


def init_moe(cfg, *, generator: torch.Generator, device="cuda",
             lead: tuple = ()) -> dict:
    """The reference's ``init_moe`` tree, each leaf with ``lead`` leading
    axes: ``router [d, e]`` in float32 whatever ``param_dtype`` is, the
    routed experts ``w_gate``, ``w_up [e, d, f]`` and ``w_down [e, f,
    d]``, and the shared experts ``ws_gate``, ``ws_up [d, s * f]``,
    ``ws_down [s * f, d]``."""
    dev = resolve_device(device)
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    fs = cfg.moe_shared * f
    kw = dict(generator=generator, dtype=cfg.param_dtype, device=dev,
              lead=lead)
    return {
        "router": dense_init(d, e, generator=generator, dtype=torch.float32,
                             device=dev, lead=lead),
        "w_gate": _expert_stack(e, d, f, **kw),
        "w_up": _expert_stack(e, d, f, **kw),
        "w_down": _expert_stack(e, f, d, **kw),
        "ws_gate": dense_init(d, fs, **kw),
        "ws_up": dense_init(d, fs, **kw),
        "ws_down": dense_init(fs, d, **kw),
    }


def moe_specs() -> dict:
    """The logical specs of :func:`init_moe`'s tree: the routed experts
    on ``experts``, the shared ones as a dense FFN."""
    return {"router": ("embed", None),
            "w_gate": ("experts", "expert_embed", "expert_mlp"),
            "w_up": ("experts", "expert_embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "expert_embed"),
            "ws_gate": ("embed", "mlp"), "ws_up": ("embed", "mlp"),
            "ws_down": ("mlp", "embed")}


def dispatch_shape(n_tok: int, cfg) -> tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group), by the
    reference's rule."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    g = min(cfg.moe_groups, n_tok) or 1
    while n_tok % g:
        g //= 2
    tg = n_tok // g
    return g, tg, int(np.ceil(tg * k / e * cfg.moe_capacity_factor))


def no_drop_capacity_factor(cfg) -> float:
    """The capacity factor ``e / k`` at which ``cap >= tg``: an expert
    takes every token of its group, so no assignment can drop (top-k
    experts of a token are distinct)."""
    return cfg.moe_experts / cfg.moe_top_k


class Routing(NamedTuple):
    """The dispatch of one ``moe_ffn`` call, per group ``[g, ...]``:
    ``top_e`` / ``top_p`` [g, tg, k] (weights after ``moe_norm_topk``),
    ``probs`` [g, tg, e], then per sorted assignment [g, tg * k] the
    source token ``st``, the weight ``sp``, ``keep`` and the slot
    (``slot_e``, ``slot_c``; dropped ones on the dump expert e, row 0)."""
    top_e: torch.Tensor
    top_p: torch.Tensor
    probs: torch.Tensor
    st: torch.Tensor
    sp: torch.Tensor
    keep: torch.Tensor
    slot_e: torch.Tensor
    slot_c: torch.Tensor
    cap: int


def route(router: torch.Tensor, tokens: torch.Tensor, cfg) -> Routing:
    """The reference's routing of ``tokens [g, tg, d]`` (float32 logits,
    softmax, top k, stable sort by expert, rank within an expert)."""
    g, tg, _ = tokens.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = dispatch_shape(g * tg, cfg)[2]
    probs = torch.softmax(tokens.float() @ router, dim=-1)     # [g, tg, e]
    # lax.top_k's order: value descending, ties to the lower index (a
    # stable descending sort keeps equal values in index order)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    if cfg.moe_norm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(g, tg * k)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    se = flat_e.gather(1, order)
    st = torch.div(order, k, rounding_mode="floor")    # token of each slot
    sp = top_p.reshape(g, tg * k).gather(1, order)
    first_of_e = torch.searchsorted(se, se, side="left")
    pos = torch.arange(tg * k, device=tokens.device) - first_of_e
    keep = pos < cap
    return Routing(top_e, top_p, probs, st, sp, keep,
                   torch.where(keep, se, e), torch.where(keep, pos, 0), cap)


def aux_loss(r: Routing, e: int) -> torch.Tensor:
    """Switch-style load balance: e * sum(density * density proxy)."""
    density = torch.nn.functional.one_hot(r.top_e[..., 0], e).float().mean(
        dim=(0, 1))
    return (density * r.probs.mean(dim=(0, 1))).sum() * e


def undispatch(gathered: torch.Tensor, st: torch.Tensor,
               k: int) -> torch.Tensor:
    """Each token's sum of its k weighted expert rows: ``gathered [g,
    tg * k, d]`` in sorted-assignment order, ``st [g, tg * k]`` the token
    of each -> ``[g, tg, d]``.

    The reference scatter-adds the rows (``.at[].add``), rounding after
    each add in the activations' dtype.  A CUDA ``scatter_add_`` adds
    with atomics in no fixed order, so in bfloat16 two runs of the same
    prefill gave other sums (``chip_smoke.py`` phase M2 keeps it as a
    control).  Here each token's rows are gathered (a stable sort of
    ``st`` lists them in sorted order, so by ascending expert) and added
    one at a time in that order: the same bits on every run."""
    g, n, d = gathered.shape
    slots = torch.sort(st, dim=1, stable=True).indices          # [g, tg * k]
    rows = gathered.gather(1, slots[..., None].expand(-1, -1, d)).reshape(
        g, n // k, k, d)
    out = rows[:, :, 0]
    for j in range(1, k):
        out = out + rows[:, :, j]
    return out


def _dispatch(router: torch.Tensor, x: torch.Tensor, cfg):
    """Route ``x`` [b, t, d] and fill the dispatch buffer: (tokens [g,
    tg, d], its :class:`Routing`, each sorted assignment's buffer row
    [g, tg * k], the buffer [e + 1, g * cap, d])."""
    b, t, d = x.shape
    g, tg, cap = dispatch_shape(b * t, cfg)
    tokens = x.reshape(g, tg, d)
    r = route(router, tokens, cfg)
    gi = torch.arange(g, device=x.device)[:, None]
    rows = gi * cap + r.slot_c                                 # [g, tg * k]
    buf = x.new_zeros((cfg.moe_experts + 1, g * cap, d))
    buf[r.slot_e, rows] = tokens[gi, r.st]
    return tokens, r, rows, buf


def _experts(h: torch.Tensor, p: dict) -> torch.Tensor:
    """The three batched expert products of ``h`` [e', n, d] by the
    experts ``p`` holds ([e', d, f] / [e', f, d])."""
    act = swiglu(torch.bmm(h, p["w_gate"]), torch.bmm(h, p["w_up"]))
    return torch.bmm(act, p["w_down"])


def _combine(out_e: torch.Tensor, r: Routing, rows: torch.Tensor,
             cfg) -> torch.Tensor:
    """Each token's weighted expert rows added in sorted order
    (:func:`undispatch`): [g, tg, d]."""
    e = cfg.moe_experts
    # a dropped assignment reads expert e - 1's row at weight 0 where the
    # reference reads its zero dump row: the same 0 without a copy
    gathered = out_e[r.slot_e.clamp(max=e - 1), rows] * \
        (r.sp * r.keep).to(out_e.dtype)[..., None]
    return undispatch(gathered, r.st, cfg.moe_top_k)


def _shared(p: dict) -> dict:
    """The shared experts of ``p`` as a dense FFN's weights."""
    return {"w_gate": p["ws_gate"], "w_up": p["ws_up"],
            "w_down": p["ws_down"]}


def moe_dispatch(p: dict, x: torch.Tensor, cfg):
    """x [b, t, d] -> (out [b, t, d], its :class:`Routing`), the
    reference's grouped fixed-capacity dispatch (module doc) without the
    aux loss: serving reads only ``out``.

    The dispatch buffer is laid out expert-major, ``[e + 1, g * cap,
    d]`` (the reference's is ``[g, e + 1, cap, d]``), so each expert's
    rows of every group are one batched product; every output element
    is the same dot product either way."""
    b, t, d = x.shape
    _, r, rows, buf = _dispatch(p["router"], x, cfg)
    routed = _combine(_experts(buf[:cfg.moe_experts], p), r, rows, cfg)
    # the shared experts on x, as the mesh path runs them: x's gradient
    # then adds two terms in either path, the same bits at one entry
    return routed.reshape(b, t, d) + dense_ffn(_shared(p), x), r


def _moe_tp(groups, x: torch.Tensor, cfg):
    """:func:`moe_dispatch_tp`'s body: (out [b, t, d], its
    :class:`Routing`)."""
    b, t, d = x.shape
    home = x.device
    router = groups[0][2][0][1]["router"].to(home)
    tokens, r, rows, buf = _dispatch(router, x, cfg)
    out_e = buf.new_empty((cfg.moe_experts,) + tuple(buf.shape[1:]))
    n = buf.shape[1]
    step = -(-n // len(groups))
    ends = list(itertools.accumulate(p["w_gate"].shape[0]
                                     for _, p, _ in groups[0][2]))
    spans = list(zip([0] + ends[:-1], ends))
    def row(gi, b0, b1, ents):
        c0, c1 = min(gi * step, n), min((gi + 1) * step, n)
        if c1 <= c0:
            return None

        def run(i, dev, p, e):
            e0, e1 = spans[i]
            part = buf[e0:e1, c0:c1]
            count_move("dispatch", "all-to-all", 0, None,
                       part.numel() * part.element_size())
            return _experts(part.to(dev), p)
        outs = each_entry(ents, run)
        collect("dispatch", "all-to-all", outs)
        return outs

    for gi, outs in enumerate(each_row(groups, row)):
        c0, c1 = min(gi * step, n), min((gi + 1) * step, n)
        for (e0, e1), o in zip(spans, outs or ()):
            # a row a dry run ran for a larger one reads its first columns
            out_e[e0:e1, c0:c1] = o[:, :c1 - c0].to(home)
    routed = _combine(out_e, r, rows, cfg).reshape(b, t, d)
    shared = torch.cat(each_row(groups, lambda _, b0, b1, ents: psum(
        each_entry(ents, lambda i, dev, p, e: dense_ffn(
            _shared(p), x[b0:b1].to(dev))), home)))
    return routed + shared, r


def moe_dispatch_tp(groups, x: torch.Tensor, cfg):
    """:func:`moe_dispatch`'s output with the experts over the mesh's
    ``model`` axis: ``groups`` ``[(b0, b1, [(dev, p, e), ...]), ...]`` (as
    ``attention.prefill_tp`` takes them; ``p`` an entry's layer-local
    FFN weights: ``E / p`` routed experts, its columns of the shared
    ``ws_gate`` / ``ws_up`` and rows of ``ws_down``, the router whole)
    and ``x`` [b, t, d] on the controller's device.

    ``route`` runs on ``x``'s device with the replicated router (the
    first entry's), as on one device, and fills the whole dispatch
    buffer there.  Model entry m computes the three batched products of
    its experts' slice of the buffer, the buffer's rows split over the
    batch ranges (``data``); the slices go back into the whole buffer in
    expert order and :func:`undispatch` adds each token's rows as on one
    device.  The shared experts run as a dense FFN split over ``mlp``,
    the entries' partial outputs summed in entry order.  Returns out [b,
    t, d]."""
    return _moe_tp(groups, x, cfg)[0]


def moe_ffn_tp(groups, x: torch.Tensor, cfg):
    """:func:`moe_ffn` over the mesh (``groups`` and ``x`` as
    :func:`moe_dispatch_tp` takes them; under FSDP each ``p`` an entry's
    gathered view, only the first entry's with the router):
    differentiable, (out [b, t, d], aux loss) with the aux loss of the
    whole routing, as one device computes it."""
    out, r = _moe_tp(groups, x, cfg)
    return out, aux_loss(r, cfg.moe_experts)


def ffn_tp(groups, x: torch.Tensor, cfg) -> torch.Tensor:
    """A layer's FFN over the mesh's ``model`` axis (``groups`` and ``x``
    as :func:`moe_dispatch_tp` takes them): the MoE by
    :func:`moe_dispatch_tp`, the dense SwiGLU split over ``mlp``
    (``w_gate`` / ``w_up`` by column, ``w_down`` by row), each entry's
    partial output summed in entry order on ``x``'s device."""
    if cfg.is_moe:
        return moe_dispatch_tp(groups, x, cfg)
    return torch.cat(each_row(groups, lambda _, b0, b1, ents: psum(
        each_entry(ents, lambda i, dev, p, e: dense_ffn(
            p, x[b0:b1].to(dev))), x.device)))


def moe_ffn(p: dict, x: torch.Tensor, cfg):
    """x [b, t, d] -> (out [b, t, d], aux loss scalar), as the
    reference's ``moe_ffn`` returns them (:func:`moe_dispatch`, then
    :func:`aux_loss`)."""
    out, r = moe_dispatch(p, x, cfg)
    return out, aux_loss(r, cfg.moe_experts)


__all__ = ["Routing", "aux_loss", "dense_ffn", "dense_ffn_specs",
           "dispatch_shape", "ffn_tp", "init_dense_ffn", "init_moe",
           "moe_dispatch", "moe_dispatch_tp", "moe_ffn", "moe_ffn_tp",
           "moe_specs",
           "no_drop_capacity_factor", "route", "undispatch"]
