"""AdamW with production knobs (port of ``repro.train.optimizer``).

* **Gradient clipping** by global norm.
* **Gradient compression** (optional): error-feedback int8 quantization
  -- the classic 1-bit-Adam-style trick for slow inter-pod links [Seide
  et al. 2014; Tang et al. arXiv:2102.02888].  The residual is carried
  in the optimizer state.
* **Schedules**: linear warmup + cosine decay.

Functions take and return trees of tensors (nested dicts, lists, tuples
and named tuples, in ``checkpoint.flatten``'s leaf order) and never
write their inputs.  The moments are float32; a bfloat16 parameter is
updated in float32 and rounded back.  Scalars follow the reference's
float32 arithmetic: the schedule, ``b1 ** step`` and the clip factor
are float32 tensors on the parameters' device, so a step needs no host
sync.

**ZeRO-style state sharding.**  ``state_specs`` gives the moments the
parameters' logical specs (the reference's); ``place_state`` lays
``mu``, ``nu`` and ``err`` out over a mesh by them
(``launch.mesh.place``: one shard per distinct block and device).
``apply`` on a placed state scatters each gradient into the state's
shards, takes the global norm once over the distinct blocks (a block
held by several entries counts once), updates each shard on its own
device -- each copy of a replicated block, so that the copies stay
equal -- and gathers the new parameters whole on their own device.  The
compression scale is a per-tensor maximum, so it is taken over the
blocks first.  Only the norm's float32 summation order differs from the
unplaced step.  Under FSDP the parameters and their gradients are laid
out too (``launch.steps``' ``place_args``; the gradients by
``launch.mesh.ShardGrads``), as the moments: each parameter shard is
updated on its device beside its moments' shards and the new parameters
stay laid out, and a placed ``step`` advances on every copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import sharding as SH
from repro_torch.launch.mesh import Placed, gather, place
from repro_torch.models.common import load_tree
from repro_torch.train.checkpoint import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress: bool = False       # error-feedback int8 gradient compression


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any             # first moments (tree like params), float32
    nu: Any             # second moments
    err: Any            # compression residual (or a tree of 0-d zeros)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), rebuilt in ``tree``'s structure."""
    leaves, td = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def init(params, cfg: AdamWConfig) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    err = tree_map(zeros if cfg.compress else
                   (lambda p: torch.zeros((), dtype=torch.float32,
                                          device=p.device)), params)
    leaves = flatten(params)[0]
    dev = leaves[0].device if leaves else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    err=err)


def load_reference_state(state, *, device="cuda") -> OptState:
    """The reference's ``OptState`` (leaves as numpy arrays) as the
    port's, on ``device``."""
    return OptState(*(load_tree(x, device=device) for x in state))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares; a placed
    leaf's over its distinct blocks, each once, added on the first
    placed leaf's first entry's device."""
    total, home = 0, None
    for x in flatten(tree)[0]:
        if isinstance(x, Placed):
            home = home or x.entry_keys[0][1]
            for _, _, shard in x.blocks:
                total = total + torch.sum(torch.square(shard.to(
                    torch.float32))).to(home)
        else:
            total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# -------------------------------------------------------------------------
# Error-feedback int8 compression (per-tensor scale).
# -------------------------------------------------------------------------
def _compress_decompress(g: torch.Tensor, err: torch.Tensor, scale=None):
    """Quantize (g + err) to int8 with a per-tensor absmax scale (or
    ``scale``, one taken over a whole tensor's shards); return the
    dequantized value and the new residual (``round`` is half to even,
    as ``jnp.round``)."""
    g32 = g.to(torch.float32) + err
    if scale is None:
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g32 - deq


def _keep(new, old, finite):
    return new if finite is None else torch.where(finite, new, old)


def _update(cfg: AdamWConfig, p, g, m, v, e, clip, lr, b1c, b2c,
            finite=None, scale=None):
    """One leaf's (or one shard's) AdamW update from its gradient ``g``:
    (p, m, v, e) new, each kept at its input where ``finite`` is false.
    The scalars lie on the leaf's device; ``e`` is only read with
    ``compress``."""
    g = g.to(torch.float32) * clip
    if cfg.compress:
        g, e_new = _compress_decompress(g, e, scale)
        e = _keep(e_new, e, finite)
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
    delta = delta + cfg.weight_decay * p.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
    return (_keep(p_new, p, finite), _keep(m_new, m, finite),
            _keep(v_new, v, finite), e)


def apply(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW update. Returns (new_params, new_state, stats).  On a
    state laid out by :func:`place_state` the update runs shard by shard
    (module doc) and the new state stays laid out."""
    return _apply(params, grads, state, cfg)


def state_specs(param_specs, compress: bool = False) -> OptState:
    """Logical sharding specs for ``OptState``, mirroring the parameter
    specs (the reference's ``optimizer.py:125``): the residual's too
    with ``compress``, else ``()`` for its 0-d leaves."""
    err = param_specs if compress else SH.map_specs(lambda _: (),
                                                    param_specs)
    return OptState(step=(), mu=param_specs, nu=param_specs, err=err)


def place_state(state: OptState, specs: OptState, mesh) -> OptState:
    """``state`` with ``mu``, ``nu`` and ``err`` laid out over ``mesh``
    by ``specs`` (:func:`state_specs`) through ``FSDP_TP``; ``step``
    stays on its device."""
    def lay(tree, spec_tree):
        shardings = flatten(SH.resolve_tree(spec_tree, SH.FSDP_TP, mesh))[0]
        leaves, td = flatten(tree)
        if len(shardings) != len(leaves):
            raise ValueError(f"{len(leaves)} state leaves but "
                             f"{len(shardings)} specs")
        return unflatten(td, [place(x, sh) for x, sh in
                              zip(leaves, shardings)])
    return OptState(step=state.step, mu=lay(state.mu, specs.mu),
                    nu=lay(state.nu, specs.nu), err=lay(state.err, specs.err))


def gather_state(state: OptState, device=None) -> OptState:
    """A placed state's leaves whole on ``device`` (default each leaf's
    first entry's device)."""
    def whole(tree):
        leaves, td = flatten(tree)
        return unflatten(td, [gather(x, device) if isinstance(x, Placed)
                              else x for x in leaves])
    return OptState(step=state.step, mu=whole(state.mu), nu=whole(state.nu),
                    err=whole(state.err))


def is_placed(state: OptState) -> bool:
    return any(isinstance(x, Placed) for x in flatten(state.mu)[0])


def _apply(params, grads, state: OptState, cfg: AdamWConfig, finite=None):
    """:func:`apply`; with ``finite`` (a bool tensor) every output leaf
    is the update where it holds and the input where it does not, and
    the stats read NaN and 0 -- the loop's overflow guard, without a
    host sync.  Each leaf is cast, clipped, compressed and updated in
    turn (the reference casts every gradient first: the same numbers)."""
    if is_placed(state):
        return _apply_placed(params, grads, state, cfg, finite)
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    leaves, td = flatten(params)
    out = [_update(cfg, *xs, clip, lr, b1c, b2c, finite)
           for xs in zip(leaves, flatten(grads)[0], flatten(state.mu)[0],
                         flatten(state.nu)[0], flatten(state.err)[0])]
    new_params, mu, nu, err = (unflatten(td, [o[i] for o in out])
                               for i in range(4))
    if not cfg.compress:
        err = state.err
    stats = {"grad_norm": gnorm, "lr": lr}
    if finite is not None:
        stats = {"grad_norm": torch.where(finite, gnorm, math.nan),
                 "lr": torch.where(finite, lr, 0.0)}
    return new_params, OptState(step=step, mu=mu, nu=nu, err=err), stats


def _slices(bounds) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in bounds)


class _OnDevice:
    """A controller tensor's copy on each device, made once."""

    def __init__(self, x: torch.Tensor) -> None:
        self.copies = {x.device: x}

    def __call__(self, dev) -> torch.Tensor:
        if dev not in self.copies:
            self.copies[dev] = self.copies[next(iter(self.copies))].to(dev)
        return self.copies[dev]


def _apply_placed(params, grads, state: OptState, cfg: AdamWConfig,
                  finite=None):
    """:func:`_apply` over a state laid out by :func:`place_state`, or by
    ``launch.steps``' ``place_args`` together with the parameters and
    their gradients (FSDP: a placed ``step`` too, each copy advanced)."""
    step_in = state.step
    if isinstance(step_in, Placed):
        step_in = step_in.shard(0)
    step = step_in + 1
    p_leaves, td = flatten(params)
    g_leaves = flatten(grads)[0]
    mus, nus, errs = (flatten(t)[0] for t in (state.mu, state.nu, state.err))
    ctrl = step.device
    for p, g, m in zip(p_leaves, g_leaves, mus):
        for x in (p, g):
            if isinstance(x, Placed) and x.sharding != m.sharding:
                raise ValueError(f"a parameter or gradient laid out by "
                                 f"{x.sharding.spec}, its moments by "
                                 f"{m.sharding.spec}")
    # each gradient scattered into its moments' shards (a placed one is)
    g_sh = [g.shards if isinstance(g, Placed) else
            {key: g[_slices(m.bounds(key[0]))].to(key[1])
             for key in m.shards} for g, m in zip(g_leaves, mus)]
    total = torch.zeros((), dtype=torch.float32, device=ctrl)
    for g, m in zip(g_sh, mus):
        for key, _, _ in m.blocks:          # each block once
            total = total + torch.sum(torch.square(
                g[key].to(torch.float32))).to(ctrl)
    gnorm = torch.sqrt(total)
    clip = _OnDevice(torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0))
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    lr_on, b1c, b2c = (_OnDevice(x) for x in (lr, 1 - cfg.b1 ** sf,
                                              1 - cfg.b2 ** sf))
    ok = None if finite is None else _OnDevice(finite)
    new_p, new_m, new_v, new_e = [], [], [], []
    for p, g, m, v, e in zip(p_leaves, g_sh, mus, nus, errs):
        scale = None
        if cfg.compress:
            # the per-tensor scale: the largest magnitude over the blocks
            amax = torch.stack(
                [(g[key].to(torch.float32) * clip(key[1])
                  + e.shards[key]).abs().max().to(ctrl)
                 for key, _, _ in m.blocks if g[key].numel()]
                or [torch.zeros((), device=ctrl)]).max()
            scale = _OnDevice(torch.clamp(amax, min=1e-12) / 127.0)
        sh = {}
        for key, gk in g.items():
            dev = key[1]
            sh[key] = _update(
                cfg, p.shards[key] if isinstance(p, Placed) else
                p[_slices(m.bounds(key[0]))].to(dev), gk,
                m.shards[key], v.shards[key],
                e.shards[key] if cfg.compress else None, clip(dev),
                lr_on(dev), b1c(dev), b2c(dev),
                None if ok is None else ok(dev),
                None if scale is None else scale(dev))

        def placed(old, i):
            return Placed(old.sharding, old.shape, old.dtype,
                          {key: x[i] for key, x in sh.items()},
                          old.entry_keys)
        if isinstance(p, Placed):
            new_p.append(placed(p, 0))
        else:
            out = torch.empty_like(p)
            for key, bounds, _ in m.blocks:
                out[_slices(bounds)] = sh[key][0].to(p.device)
            new_p.append(out)
        new_m.append(placed(m, 1))
        new_v.append(placed(v, 2))
        if cfg.compress:
            new_e.append(placed(e, 3))
    err = unflatten(flatten(state.err)[1], new_e) if cfg.compress \
        else state.err
    new_step = state.step.map(lambda t, *_: t + 1) \
        if isinstance(state.step, Placed) else step
    new_state = OptState(step=new_step,
                         mu=unflatten(flatten(state.mu)[1], new_m),
                         nu=unflatten(flatten(state.nu)[1], new_v), err=err)
    stats = {"grad_norm": gnorm, "lr": lr}
    if finite is not None:
        stats = {"grad_norm": torch.where(finite, gnorm, math.nan),
                 "lr": torch.where(finite, lr, 0.0)}
    return unflatten(td, new_p), new_state, stats


__all__ = ["AdamWConfig", "OptState", "apply", "gather_state",
           "global_norm", "init", "is_placed", "load_reference_state",
           "place_state", "schedule", "state_specs", "tree_map"]
