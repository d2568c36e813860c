"""Fault-tolerant training loop (port of ``repro.train.loop``).

* **checkpoint/restart** -- periodic async checkpoints of (params, opt
  state); ``run`` resumes from the last committed step, and the data
  is keyed by step (``data_fn(step)``), so a restarted run replays the
  same batches: the final parameters equal an uninterrupted run's bit
  for bit where the step itself is deterministic (on the card,
  ``torch.use_deterministic_algorithms`` makes it so where an op adds
  with atomics, such as the GNNs' ``index_add_``).
* **failure injection** -- ``FailAfter`` raises mid-run to let tests
  prove restart equivalence.
* **straggler / hang watchdog** -- once 5 steps have set a baseline,
  each step must complete within ``step_timeout_factor`` x the median
  step (at least ``min_timeout_s``), else ``StragglerTimeout`` is raised
  for the supervisor to restart from the last checkpoint.
* **NaN/overflow guard** -- a step whose loss or gradient norm is not
  finite leaves the parameters and moments as they were, advances
  ``state.step`` and reports ``grad_norm`` NaN, ``lr`` 0, ``skipped`` 1.

The step is eager: gradients come from ``torch.autograd.grad`` on leaf
tensors that require grad (``torch.func``'s transforms do not compose
with ``torch.utils.checkpoint``, which the LM's ``remat`` uses), and
the guard selects each leaf on the device, so a step syncs with the
host once, when ``run`` reads the loss (the reference's
``block_until_ready``).

The same step runs FSDP on a tree laid out by ``param_specs`` through
``FSDP_TP`` (``launch.steps``' ``place_args``): :func:`value_and_grad`
takes the placed path (its doc), and ``optimizer.apply`` updates each
parameter shard beside its moments' shards, so the new parameters and
state keep the arguments' layout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Placed, ShardGrads
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import flatten, unflatten


class StragglerTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    step_timeout_factor: float = 20.0   # x median step time
    min_timeout_s: float = 30.0


@dataclasses.dataclass
class FailAfter:
    """Test hook: raise after N successful steps (simulated host crash)."""
    steps: int
    exc: type = RuntimeError


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the gradient of every leaf of ``params`` (zeros
    where the loss does not reach it), in ``params``' tree and dtypes.

    A tree of placed leaves (``launch.steps``' ``place_args``) takes the
    FSDP path: the loss takes each mesh entry's view of a leaf through
    ``launch.mesh.entry_view``, and the backward runs inside a
    ``launch.mesh.ShardGrads``, which reduce-scatters the views'
    gradients onto the leaves' shards; each gradient is a ``Placed`` of
    its leaf's layout."""
    leaves, td = flatten(params)
    if any(isinstance(x, Placed) for x in leaves):
        if not all(isinstance(x, Placed) for x in leaves):
            raise ValueError("a tree with placed leaves trains only with "
                             "every leaf placed (place_args)")
        with ShardGrads(leaves[0].entry_keys[0][1]) as sink, \
                torch.enable_grad():
            loss = loss_fn(params, batch)
            torch.autograd.grad(loss, [sink.anchor], allow_unused=True)
        return loss.detach(), sink.result(params)
    live = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(td, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), unflatten(td, grads)


def make_train_step_fn(loss_fn: Callable, opt_cfg: opt.AdamWConfig):
    """Step fn (params, state, batch) -> (params, state, stats)."""

    def step(params, state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            finite = torch.isfinite(loss) & torch.isfinite(
                opt.global_norm(grads))
            new_params, new_state, stats = opt._apply(
                params, grads, state, opt_cfg, finite=finite)
        stats = dict(stats, loss=loss, skipped=(~finite).to(torch.int32))
        return new_params, new_state, stats

    return step


# The reference's jitted step: here the step is eager, makes new trees
# and leaves the old ones to the caller (nothing to donate).
make_train_step = make_train_step_fn


def run(params, loss_fn, data_fn: Callable[[int], Any],
        opt_cfg: opt.AdamWConfig, loop_cfg: LoopConfig,
        fail_after: Optional[FailAfter] = None,
        train_step=None):
    """Run (or resume) training.

    ``data_fn(step) -> batch`` must be deterministic in ``step``.
    Returns (params, opt_state, history list of stats dicts).
    """
    # copy, so the caller's tree survives and no two leaves share storage
    params = opt.tree_map(lambda x: x.detach().clone(), params)
    state = opt.init(params, opt_cfg)
    start = 0
    if loop_cfg.ckpt_dir:
        leaves = flatten(params)[0]
        try:
            (params, state), start, _ = ckpt.restore(
                loop_cfg.ckpt_dir, (params, state),
                device=leaves[0].device)
            start += 1  # committed step already done
        except FileNotFoundError:
            pass
    step_fn = train_step or make_train_step(loss_fn, opt_cfg)
    saver = ckpt.AsyncSaver()
    history = []
    times: list[float] = []
    for step in range(start, loop_cfg.total_steps):
        t0 = time.monotonic()
        batch = data_fn(step)
        params, state, stats = step_fn(params, state, batch)
        float(stats["loss"])                 # the step's one host sync
        dt = time.monotonic() - t0
        # straggler watchdog (trips only after a baseline exists)
        if len(times) >= 5:
            limit = max(loop_cfg.min_timeout_s,
                        loop_cfg.step_timeout_factor * float(np.median(times)))
            if dt > limit:
                raise StragglerTimeout(
                    f"step {step} took {dt:.1f}s (limit {limit:.1f}s)")
        times.append(dt)
        if step % loop_cfg.log_every == 0:
            history.append({k: float(v) for k, v in stats.items()})
        if (loop_cfg.ckpt_dir and step % loop_cfg.ckpt_every == 0
                and step > 0):
            saver.save(loop_cfg.ckpt_dir, step, (params, state))
            ckpt.gc_old(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts)
        if fail_after is not None and (step - start + 1) >= fail_after.steps:
            saver.wait()
            raise fail_after.exc(f"injected failure at step {step}")
    if loop_cfg.ckpt_dir:
        saver.save(loop_cfg.ckpt_dir, loop_cfg.total_steps - 1,
                   (params, state))
        saver.wait()
    return params, state, history


__all__ = ["FailAfter", "LoopConfig", "StragglerTimeout", "make_train_step",
           "make_train_step_fn", "run", "value_and_grad"]
