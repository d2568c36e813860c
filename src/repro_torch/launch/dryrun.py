"""Dry run of every (arch x shape) cell on a production mesh of H100s,
on the meta device: the counterpart of ``src/repro/launch/dryrun.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # every cell
  python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16 mesh
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --all --variant ring  # the ring cells

This is the one entry point of the port that needs no card, as the
reference's dry run ran on forced host devices: it never looks for
CUDA.  No cell is compiled and nothing is placed on a card.  A cell's
bundle (``launch.steps.make_bundle``) gives its arguments as meta
tensors; they are laid out over a mesh of ``"meta"`` entries
(16 x 16, or 2 x 16 x 16 with ``--multi-pod``) by the reference's rules
(``FSDP_TP``, or ``drop_pod(FSDP_TP)`` on one pod) after
:func:`fit_shardings` drops each mesh axis from a dimension it does not
divide, and the port's own step (``StepBundle.get_fn(mesh, rules)``)
runs on them under a count (``launch.collectives.counted``).  Each
cell writes ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``; a
record already written is reused unless ``--force``, an ``error``
record is retried.

The record keeps the reference's keys where their meaning carries
over, so that the reference's ``roofline.table`` renders it: ``status``
(``ok``, ``host_sync`` or ``error``), ``chips``, ``model_flops``,
``notes``; ``memory`` (``argument_size_in_bytes``,
``output_size_in_bytes``, and ``temp_size_in_bytes``: the peak live
bytes of the tensors the step makes); ``flops_per_device`` (by
``torch.utils.flop_counter``'s formulas, those of ``FlopCounterMode``,
plus flash_decode's ``cost``: elementwise ops count nothing there);
``bytes_per_device`` (each op's inputs read and outputs written, each
collective's bytes sent and received) and ``bytes_by_op``;
``collective_wire_bytes_per_device``, ``collective_counts``,
``collective_by_op_bytes`` (what the port's collectives move,
``launch.collectives.collective_stats``) and
``ring_estimate_by_op_bytes`` (the reference's ring estimate of the
same collectives); ``ops``; ``compute_term_s``, ``memory_term_s`` and
``collective_term_s`` against the H100's data-sheet rates
(``launch.mesh``; the collective term sends bytes within an 8-GPU node
over NVLink and between nodes over the NIC, each at its own rate, the
two at once); ``dominant_term``, ``model_flops_per_device``,
``useful_flops_ratio``; ``fits`` (arguments, outputs and temp within
the card's 80 GB); ``dry_s``.  Each per-device figure is the largest
entry's, the sum over the entries beside it (``*_sum``).

Where the sum over entries differs from a one-entry count of the same
step: padded heads (each entry computes its padded query heads, the
one-entry step pads them too but only once), the GNN cells' pad edge
slots (each entry's shard carries its share of them), and the
controller's once-only work (embedding, norms, routing, the node
update, the merges), which entry 0 does once for all.

Alike entries: the 256 or 512 entries of a production mesh would run
every layer 256 or 512 times in Python.  The count runs the work of
entries whose work has the same shapes once and charges it to each
(``launch.mesh.alike``): the model entries of a data row past the
first, the edge shards of the GNNs past the first, the ring's blocks
and steps, the query shards.  Collectives charge their moves by formula
(``launch.mesh``).

The reference's ``--unroll`` and ``_run_cell_subprocess`` have no
counterpart: eager loops count every layer and step in full, and meta
tensors hold no memory, so every cell runs in this one process.

Three dspc cells read a device value on the host: ``build`` (the BFS
frontier's ``bool(frontier.any())``), ``inc_update`` and
``dec_update`` (the event's endpoints, ``int(a)``).  A meta tensor has
no value to read, so they stop there with ``status: "host_sync"``, the
line that read it and their argument bytes; they are not errors (the
reference traces through such reads).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, NamedSharding,
                                     PartitionSpec, Placed, map_tree,
                                     make_mesh, mesh_chips, place_tree)
from repro_torch.launch.steps import all_cells, make_bundle

#: Device memory of one H100 SXM (data sheet), against which ``fits``.
HBM_BYTES = 80e9
#: The reference's production meshes.
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
#: The cells each variant takes (the reference's make_bundle refuses the
#: others).
VARIANT_CELLS = {"ring": (("equiformer-v2", "full_graph_sm"),
                          ("equiformer-v2", "ogb_products"))}


def _fit(sh: NamedSharding, x) -> NamedSharding:
    spec = list(sh.spec) + [None] * (len(x.shape) - len(sh.spec))
    out = []
    for dim, axes in zip(x.shape, spec):
        if axes is None:
            out.append(None)
            continue
        kept, size = [], 1
        for a in axes if isinstance(axes, tuple) else (axes,):
            if dim % (size * sh.mesh.shape[a]) == 0:
                kept.append(a)
                size *= sh.mesh.shape[a]
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return NamedSharding(sh.mesh, PartitionSpec(*out))


def fit_shardings(shardings, abstract):
    """The reference's ``_fit_shardings``: each mesh axis dropped from a
    dimension it does not divide (a batch of one decode request on a
    data axis of 16 is replicated), so that ``place_tree``, which raises
    on an uneven split, lays the tree out.  Trees of the same
    structure; leaves paired by place, not by position."""
    return map_tree(lambda _, x, sh: _fit(sh, x), abstract, shardings)


def mesh_name(multi_pod: bool, mesh_shape=None, variant: str = "",
              smoke: bool = False) -> str:
    name = ("pod2x16x16" if multi_pod else "pod16x16") if mesh_shape is \
        None else "mesh" + "x".join(str(n) for n in mesh_shape)
    for tag in (variant, "smoke" if smoke else ""):
        if tag:
            name += f"__{tag}"
    return name


def meta_mesh(multi_pod: bool, mesh_shape=None):
    """A mesh of ``"meta"`` entries: the production one, or
    ``mesh_shape`` over ``("data", "model")`` (``("pod", "data",
    "model")`` for three axes)."""
    shape, axes = MESHES[multi_pod]
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
        axes = MESHES[len(shape) == 3][1]
    return make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


def _leaves(tree) -> list:
    out = []
    map_tree(lambda _, x: out.append(x), tree)
    return out


def entry_bytes(tree, n: int) -> np.ndarray:
    """Bytes each entry holds of ``tree``: its shard of each placed
    leaf, a whole tensor on entry 0 (the controller)."""
    out = np.zeros(n)
    for x in _leaves(tree):
        if isinstance(x, Placed):
            for e in range(n):
                t = x.shard(e)
                out[e] += t.numel() * t.element_size()
        elif isinstance(x, torch.Tensor):
            out[0] += x.numel() * x.element_size()
    return out


def place_cell(bundle, mesh, rules) -> tuple:
    """The bundle's abstract arguments laid out over ``mesh`` on fitted
    shardings (:func:`fit_shardings`)."""
    return tuple(place_tree(a, fit_shardings(SH.resolve_tree(sp, rules,
                                                             mesh), a))
                 for a, sp in zip(bundle.abstract_args, bundle.arg_specs))


def host_read(exc: BaseException):
    """(op, file:line) of a read of a meta tensor's value on the host --
    ``bool(...)``, ``int(...)``, ``.item()`` -- or ``None``."""
    msg = str(exc)
    if not ("meta" in msg and ("item" in msg or "data-dependent" in msg
                                or "Cannot" in msg or "scalar" in msg)):
        return None
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename and
              not f.filename.endswith("collectives.py")]
    if not frames:
        return None
    f = frames[-1]
    where = f.filename[f.filename.index("repro_torch"):]
    return f.line, f"src/{where}:{f.lineno}"


def count_step(fn, args, n: int, device="meta") -> tuple:
    """``fn(*args)`` under a count of ``n`` entries on ``device`` (alike
    entries run once on meta): (outputs, tally, seconds)."""
    t0 = time.monotonic()
    with C.counted(n, device, alike=torch.device(device).type == "meta") \
            as tally:
        out = fn(*args)
    return out, tally, time.monotonic() - t0


def terms(tally, out_bytes, arg_bytes, model_flops: float,
          chips: int) -> dict:
    """The record's counted figures and roofline terms (module doc)."""
    coll = C.collective_stats(tally)
    flops = float(tally.flops.max())
    nbytes = float(tally.bytes.max())
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = C.collective_seconds(tally)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])
    mem = {"argument_size_in_bytes": int(arg_bytes.max()),
           "output_size_in_bytes": int(out_bytes.max()),
           "temp_size_in_bytes": int(tally.peak.max())}
    ring = {op: v for op, v in sorted(tally.ring.items())}
    return dict(
        memory=mem,
        memory_sum={"argument_size_in_bytes": int(arg_bytes.sum()),
                    "output_size_in_bytes": int(out_bytes.sum()),
                    "temp_size_in_bytes": int(tally.peak.sum())},
        flops_per_device=flops, flops_sum=float(tally.flops.sum()),
        bytes_per_device=nbytes, bytes_sum=float(tally.bytes.sum()),
        bytes_by_op=dict(sorted(tally.bytes_by_op.items())),
        flops_by_op={k: v for k, v in sorted(tally.flops_by_op.items())
                     if v},
        collective_wire_bytes_per_device=coll.wire_bytes,
        collective_result_bytes=coll.result_bytes,
        collective_counts=coll.counts,
        collective_by_op_bytes=coll.by_op_bytes,
        ring_estimate_by_op_bytes=ring,
        ops=C.count_ops(tally),
        compute_term_s=compute_s, memory_term_s=memory_s,
        collective_term_s=collective_s, dominant_term=dominant[0],
        model_flops_per_device=model_flops / chips,
        useful_flops_ratio=(model_flops / chips / flops if flops else None),
        fits=bool(mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                  + mem["temp_size_in_bytes"] <= HBM_BYTES))


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             out_dir: str = "results/dryrun_torch", force: bool = False,
             rules=None, variant: str = "", mesh_shape=None,
             smoke: bool = False) -> dict:
    """One cell's record (module doc), written to and reused from
    ``out_dir``.  ``mesh_shape`` (a smaller meta mesh) and ``smoke``
    (the SMOKE config) serve the tests."""
    name = mesh_name(multi_pod, mesh_shape, variant, smoke)
    cell_dir = os.path.join(out_dir, name)
    os.makedirs(cell_dir, exist_ok=True)
    path = os.path.join(cell_dir, f"{arch}__{shape}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") in ("ok", "host_sync"):
            return cached
        # a cached error is retried: the code may have been fixed since
    t0 = time.monotonic()
    mesh = meta_mesh(multi_pod, mesh_shape)
    chips = mesh_chips(mesh)
    if rules is None:
        rules = SH.FSDP_TP if "pod" in mesh.axis_names else \
            SH.drop_pod(SH.FSDP_TP)
    rec = {"arch": arch, "shape": shape, "mesh": name, "chips": chips,
           "status": "error"}
    try:
        bundle = make_bundle(arch, shape, smoke=smoke, variant=variant)
        rec.update(model_flops=bundle.model_flops, notes=bundle.notes)
        args = place_cell(bundle, mesh, rules)
        arg_bytes = entry_bytes(args, chips)
        rec["memory"] = {"argument_size_in_bytes": int(arg_bytes.max())}
        out, tally, run_s = count_step(bundle.get_fn(mesh, rules), args,
                                       chips)
        rec.update(status="ok", run_s=run_s,
                   **terms(tally, entry_bytes(out, chips), arg_bytes,
                           bundle.model_flops, chips))
    except Exception as e:  # record the failure; the suite reports it
        read = host_read(e)
        if read is not None:
            rec.update(status="host_sync", host_read=read[0],
                       host_read_at=read[1])
        else:
            rec.update(error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    rec["dry_s"] = time.monotonic() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def line(rec: dict) -> str:
    """One line of the CLI's report for a record."""
    head = f"{rec['mesh']:14s} {rec['arch']:24s} {rec['shape']:14s}"
    if rec["status"] == "ok":
        mb = rec["memory"]["temp_size_in_bytes"] / 2 ** 20
        term = rec[rec["dominant_term"] + "_term_s"]
        return (f"[ok]   {head} dry={rec['dry_s']:7.1f}s temp={mb:9.1f}MiB "
                f"dominant={rec['dominant_term']} ({term:.2e}s)")
    if rec["status"] == "host_sync":
        return (f"[sync] {head} {rec['host_read']} at "
                f"{rec['host_read_at']}")
    return f"[FAIL] {head} {rec['error'][:140]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="",
                    help="optimization variant (e.g. 'ring')")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a:24s} {s}")
        return 0
    if args.all:
        cells = list(VARIANT_CELLS[args.variant]) if args.variant else \
            all_cells()
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = {"ok": 0, "host_sync": 0, "error": 0}
    for mp in meshes:
        for a, s in cells:
            rec = run_cell(a, s, multi_pod=mp, out_dir=args.out,
                           force=args.force, variant=args.variant)
            counts[rec["status"]] += 1
            print(line(rec), flush=True)
    print(json.dumps(counts))
    return min(counts["error"], 125)


if __name__ == "__main__":
    raise SystemExit(main())
