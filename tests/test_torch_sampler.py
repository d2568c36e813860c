"""The port's neighbour sampler (``repro_torch.models.gnn.sampler``), its
``molecule_batch`` and the GNN configs in its registry, against the
reference on the CPU; and ``chip_smoke.py``'s phase G end to end on the
CPU at ``SMOKE`` widths.

* ``synthetic_csr``, ``sample_block_caps`` and ``NeighborSampler.sample``
  for the same seed and step: the same CSR arrays, senders, receivers,
  features, labels, slots and capacities as the reference, exactly;
* ``molecule_batch``: the same arrays, exactly;
* ``configs.get("egnn" | "nequip" | "equiformer-v2")``: the reference's
  specs (configs, shapes, family, source);
* phase G with every shape cut small: each of its checks holds, the
  planted fault misses the rotation limit, and the path launches no
  kernel of the port."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.data.pipelines import molecule_batch as jax_molecule_batch
from repro.models.gnn import sampler as JS
from repro_torch import configs
from repro_torch.data import molecule_batch
from repro_torch.models.gnn import sampler as TS


def test_synthetic_csr_matches_reference():
    for args in ((500, 8, 12, 5, 3), (2000, 20, 7, 41, 0)):
        got, want = TS.synthetic_csr(*args), JS.synthetic_csr(*args)
        for name in ("indptr", "indices", "feat", "labels"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert got.n == want.n == args[0]


@pytest.mark.parametrize("fanout,seed", [((3, 2), 0), ((15, 10), 4)])
def test_sample_matches_reference(fanout, seed):
    assert TS.sample_block_caps(1024, (15, 10)) == \
        JS.sample_block_caps(1024, (15, 10)) == (169984, 168960)
    csr = JS.synthetic_csr(300, 6, 5, 7, seed=seed)
    mine = TS.NeighborSampler(TS.CSRGraph(csr.indptr, csr.indices, csr.feat,
                                          csr.labels), 8, fanout, seed=seed)
    ref = JS.NeighborSampler(csr, 8, fanout, seed=seed)
    assert (mine.node_cap, mine.edge_cap) == (ref.node_cap, ref.edge_cap)
    for step in (0, 5):
        (tb, labels, slots), (jb, jl, js) = mine.sample(step, device="cpu"), \
            ref.sample(step)
        for name in ("nodes", "senders", "receivers", "graph_id"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)), name)
        assert tb.pos is None and jb.pos is None
        assert (tb.n_node, tb.n_graph, tb.n_edge) == \
            (jb.n_node, jb.n_graph, jb.n_edge) == \
            (mine.node_cap, 1, mine.edge_cap)
        assert labels.dtype == slots.dtype == torch.int32
        np.testing.assert_array_equal(labels.numpy(), jl)
        np.testing.assert_array_equal(slots.numpy(), js)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mine.sample(0)


def test_molecule_batch_matches_reference():
    for args in ((0, 3, 6, 10, 4), (7, 5, 30, 64, 16)):
        got, want = molecule_batch(*args, seed=2), \
            jax_molecule_batch(*args, seed=2)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and \
                    got[k].tobytes() == v.tobytes(), k
            else:
                assert got[k] == v


@pytest.mark.parametrize("arch", ["egnn", "nequip", "equiformer-v2"])
def test_registry_serves_the_reference_specs(arch):
    mine, ref = configs.get(arch), jax_get(arch)
    assert arch in configs.ARCH_IDS
    assert (mine.arch_id, mine.family, mine.source) == \
        (ref.arch_id, ref.family, ref.source)
    for got, want in ((mine.config, ref.config), (mine.smoke, ref.smoke)):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert (got.pop("dtype"), want.pop("dtype")) == \
            (torch.float32, jnp.float32)
        assert got == want
    assert {k: dataclasses.asdict(s) for k, s in mine.shapes.items()} == \
        {k: dataclasses.asdict(s) for k, s in ref.shapes.items()}


def test_chip_smoke_gnn_phase_on_the_cpu(monkeypatch):
    """Phase G of ``chip_smoke.py`` on the CPU: every model at ``SMOKE``
    width, every shape cut small (the checks run CPU against CPU)."""
    import chip_smoke
    from repro_torch.configs import common as C
    from repro_torch.kernels import common
    for name in ("egnn", "nequip", "equiformer_v2"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        monkeypatch.setattr(mod, "CONFIG", mod.SMOKE)
    small = {"molecule": dict(n_nodes=6, n_edges=10, batch=10, d_feat=4),
             "full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=12,
                                   n_classes=5),
             "minibatch_lg": dict(n_nodes=500, n_edges=3000, batch_nodes=8,
                                  fanout=(3, 2), d_feat=12, n_classes=5)}
    for shape, dims in small.items():
        monkeypatch.setitem(C.GNN_SHAPES, shape, C.ShapeSpec(
            shape, C.GNN_SHAPES[shape].kind, dims))
    monkeypatch.setattr(chip_smoke, "GNN_REPS", 2)
    monkeypatch.setattr(chip_smoke, "GNN_REPS_LG", 2)
    monkeypatch.setattr(chip_smoke, "device_trace",
                        lambda fn, per=1, expect=None: (None, None, {}))
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in chip_smoke.KERNEL_SOURCES})
    out = chip_smoke.gnn_phase(counts, "the CPU", 0, device="cpu")
    assert list(out) == list(chip_smoke.GNN_SHAPE_NAMES)
    assert (out["minibatch_lg"]["n_node"], out["minibatch_lg"]["n_edge"]) \
        == (80, 72)
    assert out["full_graph_sm"]["n_edge"] == 512
    for shape, row in out.items():
        for arch in chip_smoke.GNN_ARCHS:
            n = row[arch]
            assert len(n["ms"]) == 2 and n["flops"] > 0
            assert n["rotation_rel_l2"] < 1e-5
            if shape != "minibatch_lg" and (arch != "equiformer-v2"
                                            or shape == "molecule"):
                assert n["cpu"]["max_abs_err"] < 1e-5   # CPU vs CPU
                assert n["cpu"]["precision"] == "float32"
    mol = out["molecule"]["equiformer-v2"]
    assert mol["fault_rotation_rel_l2"] > chip_smoke.GNN_ROT_TOL
    assert all(out["molecule"][a]["two_launches_max_abs_err"] == 0.0
               for a in chip_smoke.GNN_ARCHS)
    assert "top_ops_ms" not in out["minibatch_lg"]["equiformer-v2"]
    assert not any(counts.by_path["gnn"].values())
    # where float32 does not resolve the output to the tolerance (here a
    # tolerance of 0), the card and the CPU are held in float64
    monkeypatch.setattr(chip_smoke, "GNN_RTOL", 0.0)
    monkeypatch.setattr(chip_smoke, "GNN_ATOL", 0.0)
    inp = chip_smoke.gnn_shape_inputs("full_graph_sm", 1, "cpu")
    model = chip_smoke.gnn_model("nequip", inp["d_in"], inp["n_out"], 3,
                                 "cpu")
    with torch.no_grad():
        got = chip_smoke.gnn_output(model, inp["batch"], inp)
    held = chip_smoke.gnn_against_cpu(model, inp["arrays"], inp, got, "t")
    assert held["precision"] == "float64" and held["max_abs_err"] == 0.0
    assert held["cpu_f32_vs_f64"] > 0
