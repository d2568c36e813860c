"""Every cell run end to end at a tiny size on the CPU, the controls, the
planted faults, and a cell added by files alone."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_copy
from spcbench.control import reading
from spcbench.harness import run_cell

CELLS = ["enron.scan", "enron.insert", "astroph.scan"]
SEEDS = [3, 2 ** 31 + 9, 2 ** 40 + 1]


def run(root, cell, seed=SEEDS[1], trace=False):
    return run_cell(root, cell, seed, 0.4, trace, device="cpu")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, bench, cell, trace):
    result, lines = run(tiny_root, cell, trace=trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    want = [m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]
    if not trace:
        assert sorted(result["metrics"]) == sorted(want)
    else:
        # no device on the CPU: the readers of the trace read nothing
        assert set(result["metrics"]) <= set(want)
        assert "build_s" in result["metrics"]
        assert result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check pairs_checked")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell, seed):
    """The reference counting in int32 and in float32 comes out not
    correct, by the width of its counts: their values are all exact."""
    got = reading(tiny_root, cell, seed)
    assert [r["count_dtype"] for r in got] == ["int32", "float32"]
    for r in got:
        assert r["pairs_checked"] > 0
        assert r["correct"] is False
        assert r["narrow_counts"] > 0
        assert r["mismatched_pairs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny_root, cell):
    """The device path at the tiny size: K1 built and launched, the
    trace read, the answers judged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, _ = run_cell(tiny_root, cell, SEEDS[0], 0.4, True,
                         device="cuda")
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0


# -- planted faults: the timed path broken underneath a run ----------------

def altered_answers(monkeypatch):
    from repro_torch.serve.engine import QueryEngine
    real = QueryEngine.query_batch

    def query_batch(self, idx, s, t, route=None):
        d, c = real(self, idx, s, t, route)
        c = c.clone()
        c[::4] += 1
        return d, c

    monkeypatch.setattr(QueryEngine, "query_batch", query_batch)


def half_batch_left_out(monkeypatch):
    from repro_torch.serve.engine import QueryEngine
    real = QueryEngine.query_batch

    def query_batch(self, idx, s, t, route=None):
        s, t = np.asarray(s), np.asarray(t)
        half = s.size // 2
        d, c = real(self, idx, s[:half], t[:half], route)
        pad = s.size - half
        return (torch.cat([d, torch.zeros(pad, dtype=d.dtype)]),
                torch.cat([c, torch.zeros(pad, dtype=c.dtype)]))

    monkeypatch.setattr(QueryEngine, "query_batch", query_batch)


def state_unchanged(monkeypatch):
    from repro_torch.core.dynamic import DynamicSPC
    monkeypatch.setattr(DynamicSPC, "apply_events",
                        lambda self, events, batch_size=None: None)


def half_ticket_left_out(monkeypatch):
    from repro_torch.core.dynamic import DynamicSPC
    real = DynamicSPC.apply_events

    def apply_events(self, events, batch_size=None):
        events = list(events)
        real(self, events[:len(events) // 2], batch_size=batch_size)

    monkeypatch.setattr(DynamicSPC, "apply_events", apply_events)


FAULTS = {
    "scan": [altered_answers, half_batch_left_out],
    "insert": [altered_answers, state_unchanged, half_ticket_left_out],
}
CASES = [(cell, f) for cell in CELLS
         for f in FAULTS[cell.split(".")[1]]]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, _ = run(tiny_root, cell)
    assert result["correct"] is False
    assert result["checks"]["mismatched_pairs"]["value"] > 0


def narrowed_counts(monkeypatch):
    from repro_torch.serve.engine import QueryEngine
    real = QueryEngine.query_batch

    def query_batch(self, idx, s, t, route=None):
        d, c = real(self, idx, s, t, route)
        return d, c.to(torch.int32)

    monkeypatch.setattr(QueryEngine, "query_batch", query_batch)


@pytest.mark.parametrize("cell", CELLS)
def test_narrowed_counts_are_not_correct(tiny_root, monkeypatch, cell):
    """Counts answered in int32 (every value still exact) read not
    correct."""
    narrowed_counts(monkeypatch)
    result, _ = run(tiny_root, cell)
    assert result["correct"] is False
    assert result["checks"]["mismatched_pairs"]["value"] == 0
    assert result["checks"]["narrow_counts"]["value"] > 0


# -- driven by data ---------------------------------------------------------

def test_cell_added_by_files_alone(tmp_path):
    """A configuration, a mix and a metric added as new files, with a
    workload entry, run without an edit to any file that was there."""
    root = tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "spcbench").rglob("*")
              if p.is_file()}
    here = root / "spcbench"
    cfg = json.loads((here / "configs" / "enron.json").read_text())
    cfg.update(name="small", n=90, m=300)
    (here / "configs" / "small.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "scan_uniform.json").read_text())
    mix.update(batch_pairs=512, distinct_batches=2)
    (here / "traffic" / "scan_small.json").write_text(json.dumps(mix))
    (here / "metrics" / "pairs_per_request.py").write_text(
        "def read(run):\n"
        "    w = run.window\n"
        "    return w['pairs'] / w['requests'] if 'pairs' in w else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "small.scan", "config": "small",
                               "traffic": "scan_small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "pairs_per_request", "unit": "pairs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["small.scan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run(root, "small.scan")
    assert result["correct"] is True
    assert result["metrics"]["pairs_per_request"]["value"] == 512
    assert all(p.read_bytes() == b for p, b in before.items())


# -- the command ------------------------------------------------------------

def command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "spcbench/run.py", "--workload", "enron.scan",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_result_without_a_card():
    """The command refuses to run without a CUDA device (this test's
    host has none; on a card host it is the harness's own check)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = command(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and spcbench/ (no program)
    prints no result."""
    tiny_copy(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = command(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
