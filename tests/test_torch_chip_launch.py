"""``chip_smoke.py``'s phases B (the launch layer) and E (the examples)
on the CPU, at the SMOKE configurations where the card runs CONFIG:

* B1 builds all 44 cells at full size on the meta device and reports
  the reference's ``model_flops`` and the abstract trees' bytes (the
  LM's bf16 parameters at 2 bytes an element, its AdamW moments at 8);
* B2 runs the decode_32k cell's decode (the cache cut to
  B2_DECODE_BATCH, its rows written once a step, nothing past them),
  DIEN's and EGNN's train cells (every loss finite, no step skipped)
  and the dspc cells' insert and delete on a built index, each event
  followed by the BFS oracle; a lost label write or a wrong answer
  fails it;
* B3 runs the train CLI three times and finds the resumed run's final
  checkpoint equal to the uninterrupted run's bit for bit;
* E runs the eight examples (``slow``: ``fleet_spc`` starts its
  updater and replica processes);
* the launch counters of B2 and E land on the ``launch`` and
  ``examples`` paths (no kernel launches on the CPU)."""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs import get
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import random_graph_edges
from repro_torch.kernels import common
from repro_torch.launch import steps as S
from repro_torch.serve.engine import QueryEngine


def counters():
    return chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in chip_smoke.KERNEL_SOURCES})


def test_b1_cells_at_full_size():
    rows = chip_smoke.cells_phase()
    by = {r["cell"]: r for r in rows}
    assert len(by) == 44
    qwen = get("qwen2-1.5b").config
    train = by["qwen2-1.5b/train_4k"]
    n = qwen.param_count()
    assert train["param_bytes"] == 2 * sum(
        x.numel() for x in chip_smoke.tree_tensors(
            S.make_bundle("qwen2-1.5b", "train_4k").abstract_args[0]))
    assert train["opt_bytes"] >= 8 * n
    assert train["batch_bytes"] == 2 * 256 * 4096 * 4
    assert by["dspc/query_batch"]["param_bytes"] == 0
    assert by["dspc/build"]["notes"] == "op-count proxy, not FLOPs"
    for arch, shape in S.all_cells():
        assert by[f"{arch}/{shape}"]["model_flops"] == \
            S.make_bundle(arch, shape).model_flops


def test_b2_cells_and_dspc_events_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "B2_DECODE_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "B2_TRAIN_STEPS", 2)
    counts = counters()
    dec = chip_smoke.launch_decode(counts, "the CPU", 0, device="cpu",
                                   smoke=True)
    assert dec["batch"] == 2 and dec["lengths"] == [8, 11]
    assert dec["flash_decode_launches"] == 0
    train = chip_smoke.launch_train_cells(counts, "the CPU", 0,
                                          device="cpu", smoke=True)
    assert set(train) == {"dien/train_batch", "egnn/molecule"}
    for row in train.values():
        assert row["step"] == 2 and row["skipped"] == 0
    n = 60
    edges = random_graph_edges(n, 150, seed=0)
    svc = DynamicSPC(n, edges, device="cpu")
    events = chip_smoke.launch_dspc_events(svc.graph, svc.index,
                                           QueryEngine(), counts, edges, 0,
                                           1.0)
    assert set(events) == {"dspc/inc_update", "dspc/dec_update"}
    # the delete is the cell's own: edges[m // 2], as dspc_host_args picks
    assert events["dspc/dec_update"]["edge"] == list(edges[len(edges) // 2])
    assert counts.by_path["launch"] == dict.fromkeys(counts.counters, 0)


def test_b2_dspc_event_check_catches_a_wrong_update(monkeypatch):
    """An insert that leaves the index as it was must fail the oracle."""
    from repro_torch.core import graph as G
    from repro_torch.core import incremental
    n = 60
    edges = random_graph_edges(n, 150, seed=0)
    svc = DynamicSPC(n, edges, device="cpu")
    monkeypatch.setattr(incremental, "inc_spc",
                        lambda g, idx, a, b: (G.insert_edge(g, a, b), idx))
    with pytest.raises(AssertionError, match="oracle B2 dspc/inc_update"):
        chip_smoke.launch_dspc_events(svc.graph, svc.index, QueryEngine(),
                                      counters(), edges, 0, 1.0)


def test_b3_train_cli_resumes_bitwise():
    out = chip_smoke.train_cli_phase(device="cpu")
    assert out["bitwise"] and out["leaves"] > 10 and len(out["losses"]) == 5


@pytest.mark.slow
def test_e_examples_on_the_cpu():
    counts = counters()
    out = chip_smoke.examples_phase(counts, device="cpu")
    assert set(out) == {name for name, _, _ in chip_smoke.EXAMPLES} | {
        "fleet_spc"}
    assert np.isfinite([row["s"] for row in out.values()]).all()
    assert torch.cuda.is_available() or \
        counts.by_path["examples"] == dict.fromkeys(counts.counters, 0)
