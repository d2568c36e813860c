"""One run of one cell: set up, warm up, measure, judge, report.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``spcbench/configs/<config>.json``: the deployment (graph and service
  knobs);
* ``spcbench/traffic/<traffic>.json``: the mix's parameters, read by
  the traffic kind it names (``spcbench/kinds/<kind>.py``);
* ``spcbench/metrics/<metric>.py``: ``read(run) -> float | None``, the
  reader of one metric from a finished :class:`Run`.

With ``trace`` 0 the result carries the cell's end-to-end metrics, with
``trace`` 1 its per-layer metrics, the device's busy time in the traced
window and a breakdown of it.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from spcbench import check
from spcbench.reference.spc_bfs import Graph
from spcbench import graphgen
from spcbench.devtrace import Tracer

#: Top-level module names that no run may load (the JAX package of
#: this repository and JAX itself), compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(t0: float, msg: str) -> None:
    """A progress line on standard error, seconds since process start."""
    print(f"spcbench {time.perf_counter() - t0:8.2f}s {msg}", file=sys.stderr,
          flush=True)


def load_module(path: Path):
    """The module in ``path`` (file names may hold dots)."""
    name = "spcbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"{name}_{path.parent.name}",
                                                  path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics read from their files under ``root``."""

    def __init__(self, root: Path, name: str) -> None:
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name = name
        self.chips = int(self.spec["chips"])
        here = self.root / "spcbench"
        self.config = json.loads(
            (here / "configs" / f"{self.spec['config']}.json").read_text())
        self.traffic = json.loads(
            (here / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.kind = load_module(here / "kinds" / f"{self.traffic['kind']}.py")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m, moved)]
        self.readers = {m["name"]: load_module(here / "metrics"
                                               / f"{m['name']}.py")
                        for m in self.end_to_end + self.per_layer}

    def _has(self, metric: dict, moved=None) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return moved is None or metric["moves"] in moved


class Run:
    """What one run measured, as the metric readers read it."""

    def __init__(self, kind) -> None:
        self.kind = kind          # the traffic kind's driver, its inputs
        self.setup_s = self.build_s = None
        self.window: dict = {}    # what the kind's window measured
        self.state: dict = {}     # what the kind read after the window
        self.tracer = self.trace = None


def draw(cell: Cell, seed: int):
    """(n, edges, the traffic kind's driver).  The graph is the
    configuration's dataset, drawn from its ``graph_seed``, the same in
    every run; the traffic and the judged sample are drawn from ``seed``
    (independent streams)."""
    entropy = seed if seed >= 0 else [1, -seed]
    traffic_seed, sample_seed = np.random.SeedSequence(entropy).spawn(2)
    cfg = cell.config
    n = int(cfg["n"])
    edges = graphgen.chung_lu_edges(n, int(cfg["m"]), float(cfg["alpha"]),
                                    float(cfg["i0"]), int(cfg["graph_seed"]))
    return n, edges, cell.kind.Kind(n, edges, cell.traffic, traffic_seed,
                                    sample_seed)


def build_service(config: dict, n: int, edges: np.ndarray, device: str):
    from repro_torch.serve.service import SPCService
    return SPCService(
        n, edges.tolist(), l_cap=config["l_cap"],
        construct_batch=config["construct_batch"],
        vertex_order=config["vertex_order"], route=config["route"],
        replicas=config["replicas"], queue_size=config["queue_size"],
        update_batch=config["update_batch"], device=device)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def card(device: str) -> dict:
    """The device as the result names it."""
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit": limit}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None) -> tuple:
    """One run of cell ``name``: (result dict, check lines)."""
    t0 = time.perf_counter() if t_process is None else t_process
    cell = Cell(root, name)
    n, edges, kind = draw(cell, seed)
    run = Run(kind)
    log(t0, f"{name}: graph n {n} m {edges.shape[0]} and traffic drawn")
    if device.startswith("cuda"):
        import torch
        torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    svc = build_service(cell.config, n, edges, device).start()
    _sync(device)
    run.build_s = time.perf_counter() - tb
    log(t0, f"built in {run.build_s:.3f}s, l_cap {svc.spc.index.l_cap}")
    try:
        kind.warm(svc)
        _sync(device)
        run.tracer = Tracer(device) if trace else None
        run.setup_s = time.perf_counter() - t0
        log(t0, "warmed up; window opens")
        run.window = kind.window(svc, seconds, run.tracer)
        dev = card(device)
        log(t0, f"window closed after {run.window['elapsed_s']:.3f}s, "
                f"{run.window['requests']} requests")
        run.state = kind.collect(svc)
        up = svc.stats()["update"]
        log(t0, f"read back; label regrows {up.label_regrows}, "
                f"l_cap {svc.spc.index.l_cap}")
    finally:
        svc.close()
    del svc
    if run.tracer is not None:
        run.trace = run.tracer.summarise()
        log(t0, "trace read")
    numbers, checked = kind.judge(Graph(n, kind.final_edges()))
    log(t0, "judged against the reference")
    numbers["missing_answers"] = run.window["failed"]
    correct = check.verdict(numbers, checked)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   f"reading in cell {name}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace:
        tr = run.trace
        dev["busy_s"] = tr.busy_s if tr is not None else 0.0
        dev["window_s"] = tr.window_s if tr is not None else 0.0
    result = {"correct": correct, "attempted": run.window["requests"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    if run.window.get("errors"):
        result["errors"] = run.window["errors"]
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    result["checks"]["pairs_checked"] = {"value": checked, "limit": ">0"}
    return result, check.lines(numbers, checked)


def main(argv=None, t_process: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    import torch
    cell = Cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"spcbench: cell {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"spcbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0
