"""Training entry point (port of ``repro.launch.train``): ``--arch <id>``
selects a registry config and runs the AdamW step of its train cell
(``launch.steps``) from a checkpointed start.

    python -m repro_torch.launch.train --arch dien --steps 20 \\
        [--shape train_batch] [--smoke] [--ckpt-dir D] [--ckpt-every K] \\
        [--device cuda]

As the reference: the family's train shape by default; a full config
needs a pod, so with fewer than 256 devices (CUDA devices on the card,
one on the CPU) the run prints the reference's line and falls back to
``--smoke``; each step's batch is the cell's host batch drawn again
with the step as its seed; ``--ckpt-dir`` resumes from the newest
committed checkpoint there (``train.checkpoint``), saves every
``--ckpt-every`` steps and after the last; each step prints ``[train]
step N loss L (S s)``.  The step syncs with the host once, when its loss
is read.

The reference calls ``jax.distributed.initialize`` when coordinator
variables are set (``maybe_init_distributed``), one process a host.
The port has no counterpart: one controller process drives every device
of its mesh (``repro_torch.launch.mesh``), so no coordinator variable
is read.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get
from repro_torch.core.graph import resolve_device
from repro_torch.launch.steps import make_bundle, make_host_args
from repro_torch.train import checkpoint as ckpt

#: The train shape of each family, the reference's default ``--shape``.
DEFAULT_SHAPE = {"lm": "train_4k", "gnn": "molecule",
                 "recsys": "train_batch", "dspc": "inc_update"}
#: Devices the full configurations need (a pod), as in the reference.
POD_DEVICES = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None,
                    help="shape name (default: the family's train shape)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="where the step runs (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = get(args.arch)
    shape = args.shape or DEFAULT_SHAPE[spec.family]
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not args.smoke and n_dev < POD_DEVICES:
        print(f"[train] {n_dev} device(s) available; full config needs "
              f"a pod -- falling back to --smoke", flush=True)
        args.smoke = True

    bundle = make_bundle(args.arch, shape, smoke=args.smoke)
    host_args = make_host_args(args.arch, shape, device=dev)
    if len(host_args) != 3:
        raise SystemExit(f"{args.arch}/{shape} is not a train step; "
                         f"pick the family's train shape")
    params, state, _ = host_args
    step_fn = bundle.get_fn()

    def data_at(step):
        # re-seed the host batch deterministically per step
        return make_host_args(args.arch, shape, seed=step, device=dev)[2]

    start = 0
    if args.ckpt_dir:
        try:
            (params, state), start, _ = ckpt.restore(
                args.ckpt_dir, (params, state), device=dev)
            start += 1
            print(f"[train] resumed from step {start - 1}", flush=True)
        except FileNotFoundError:
            pass
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        params, state, stats = step_fn(params, state, data_at(step))
        loss = float(stats["loss"])
        print(f"[train] step {step:4d} loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if args.ckpt_dir and step % args.ckpt_every == 0 and step > 0:
            ckpt.save(args.ckpt_dir, step, (params, state))
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps - 1, (params, state))
    print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
