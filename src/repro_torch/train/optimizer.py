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
sync.  The ZeRO part of the reference (``state_specs``: the moments'
mesh specs) waits for the mesh slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

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
    """sqrt of the sum of every leaf's float32 sum of squares."""
    total = 0
    for x in flatten(tree)[0]:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# -------------------------------------------------------------------------
# Error-feedback int8 compression (per-tensor scale).
# -------------------------------------------------------------------------
def _compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + err) to int8 with a per-tensor absmax scale; return
    the dequantized value and the new residual (``round`` is half to
    even, as ``jnp.round``)."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g32 - deq


def apply(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW update. Returns (new_params, new_state, stats)."""
    return _apply(params, grads, state, cfg)


def _apply(params, grads, state: OptState, cfg: AdamWConfig, finite=None):
    """:func:`apply`; with ``finite`` (a bool tensor) every output leaf
    is the update where it holds and the input where it does not, and
    the stats read NaN and 0 -- the loop's overflow guard, without a
    host sync.  Each leaf is cast, clipped, compressed and updated in
    turn (the reference casts every gradient first: the same numbers)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def keep(new, old):
        return new if finite is None else torch.where(finite, new, old)

    def upd(p, g, m, v, e):
        g = g.to(torch.float32) * clip
        if cfg.compress:
            g, e_new = _compress_decompress(g, e)
            e = keep(e_new, e)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return keep(p_new, p), keep(m_new, m), keep(v_new, v), e

    leaves, td = flatten(params)
    out = [upd(*xs) for xs in zip(leaves, flatten(grads)[0],
                                  flatten(state.mu)[0], flatten(state.nu)[0],
                                  flatten(state.err)[0])]
    new_params, mu, nu, err = (unflatten(td, [o[i] for o in out])
                               for i in range(4))
    if not cfg.compress:
        err = state.err
    stats = {"grad_norm": gnorm, "lr": lr}
    if finite is not None:
        stats = {"grad_norm": torch.where(finite, gnorm, math.nan),
                 "lr": torch.where(finite, lr, 0.0)}
    return new_params, OptState(step=step, mu=mu, nu=nu, err=err), stats


__all__ = ["AdamWConfig", "OptState", "apply", "global_norm", "init",
           "load_reference_state", "schedule", "tree_map"]
