"""The port's step bundles of the paper's own workload (``dspc``) against
the reference's on the CPU, and the registry they are built from.

* ``inc_update`` and ``dec_update`` (the smoke cells of
  ``tests/configs/test_smoke.py``): the reference's ``make_host_args``
  output through its jitted ``inc_spc`` / ``dec_spc`` and, carried
  across by ``load_reference_args``, through the port's: the graph and
  the index byte-identical (``m2`` equal).
* ``build`` and ``query_batch``, which run through ``mesh_fn``: on a
  one-entry CPU mesh against the reference's on its one CPU device --
  the built index byte-identical, the answers equal.  The port's own
  ``make_host_args`` draws the reference's graph, edge and pairs.
* Every dspc cell at full size: meta leaves, ``model_flops`` equal to
  the reference's, the index, the batch of pairs and the edge arrays of
  its shapes and dtypes; ``m2``, a host int in the port, carries the
  ``2 m`` of a graph of the shape's edges.
* ``all_cells()`` has the reference's 44 cells, ``ASSIGNED_ARCH_IDS``
  its 10 ids, ``all_specs`` and ``FAMILY_SHAPES`` its entries;
  ``StepBundle.get_fn`` asks for a mesh where the cell needs one and
  runs the step inside the activation-sharding context given rules."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCH_IDS as J_ASSIGNED
from repro.configs import all_specs as j_all_specs
from repro.configs.common import FAMILY_SHAPES as J_FAMILY_SHAPES
from repro.launch import steps as RS
from repro_torch import sharding as SH
from repro_torch.configs import ASSIGNED_ARCH_IDS, all_specs, get
from repro_torch.configs.common import FAMILY_SHAPES
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from tests.test_torch_launch_lm import (assert_full_size_cell, host,
                                        run_both, shapes_dtypes)

GRAPH = ("src", "dst", "m2")
INDEX = ("hub", "dist", "cnt", "size", "cnt_sum", "overflow")


def assert_same_bytes(got, want, fields, what):
    for f in fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        if isinstance(g, int):
            assert g == int(w), (what, f)
            continue
        g = host(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
        assert g.tobytes() == w.tobytes(), (what, f)


@pytest.mark.parametrize("shape", ["inc_update", "dec_update"])
def test_update_cell_leaves_the_reference_state(shape):
    want, got, got_args, _ = run_both("dspc", shape)
    assert isinstance(got_args[2], torch.Tensor)
    (g, idx), (wg, widx) = got, want
    assert_same_bytes(g, wg, GRAPH, shape)
    assert_same_bytes(idx, widx, INDEX, shape)
    assert g.n == int(wg.n) and idx.n == int(widx.n)
    # the event changed the graph
    assert host(g.src).tobytes() != host(got_args[0].src).tobytes()


def test_build_and_query_cells_through_mesh_fn():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = make_host_mesh("cpu")
    (jg,) = RS.make_host_args("dspc", "build")
    (tg,) = S.make_host_args("dspc", "build", device="cpu")
    assert_same_bytes(tg, jax.tree.map(np.asarray, jg), GRAPH,
                      "port host graph")
    want = RS.make_bundle("dspc", "build", smoke=True).get_fn(jmesh)(jg)
    bundle = S.make_bundle("dspc", "build", smoke=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        bundle.get_fn()
    got = bundle.get_fn(tmesh)(tg)
    assert_same_bytes(got, jax.tree.map(np.asarray, want), INDEX, "build")

    jargs = RS.make_host_args("dspc", "query_batch")
    targs = S.make_host_args("dspc", "query_batch", device="cpu")
    assert_same_bytes(targs[0], jax.tree.map(np.asarray, jargs[0]), INDEX,
                      "port host index")
    for t, j in zip(targs[1:], jargs[1:]):
        assert host(t).tobytes() == np.asarray(j).tobytes()
    wd, wc = RS.make_bundle("dspc", "query_batch",
                            smoke=True).get_fn(jmesh)(*jargs)
    loaded = S.load_reference_args("dspc", "query_batch",
                                   jax.tree.map(np.asarray, jargs),
                                   device="cpu")
    for args in (targs, loaded):
        d, c = S.make_bundle("dspc", "query_batch",
                             smoke=True).get_fn(tmesh)(*args)
        np.testing.assert_array_equal(host(d), np.asarray(wd))
        np.testing.assert_array_equal(host(c), np.asarray(wc))
    assert (np.asarray(wc) > 0).any()


@pytest.mark.parametrize("shape", ["build", "inc_update", "dec_update",
                                   "query_batch"])
def test_dspc_full_size_cell_is_abstract_and_sized_as_reference(shape):
    got, want = assert_full_size_cell("dspc", shape, ())
    for g, w in zip(got.abstract_args, want.abstract_args):
        if hasattr(w, "src"):           # the graph: m2 is a host int here
            assert shapes_dtypes((g.src, g.dst)) == shapes_dtypes(
                (w.src, w.dst))
            assert g.m2 == 2 * get("dspc").shapes[shape].dims["m"]
        else:
            assert shapes_dtypes(g) == shapes_dtypes(w)
    assert got.notes == want.notes


def test_registry_and_cells_match_reference():
    cells = S.all_cells()
    assert len(cells) == 44 and cells == RS.all_cells()
    assert len({a for a, _ in cells}) == 11
    assert S.all_cells(include_dspc=False) == \
        RS.all_cells(include_dspc=False)
    assert ASSIGNED_ARCH_IDS == J_ASSIGNED and len(ASSIGNED_ARCH_IDS) == 10
    assert all_specs().keys() == j_all_specs().keys()
    assert {f: {k: (v.name, v.kind, v.dims) for k, v in t.items()}
            for f, t in FAMILY_SHAPES.items()} == \
        {f: {k: (v.name, v.kind, v.dims) for k, v in t.items()}
         for f, t in J_FAMILY_SHAPES.items()}
    for arch, spec in all_specs().items():
        assert spec.shapes is FAMILY_SHAPES[spec.family]
        assert len(spec.shapes) == 4, arch


def test_get_fn_runs_the_step_in_the_activation_context():
    seen = []
    bundle = S.StepBundle(name="probe", fn=lambda: seen.append(
        list(SH._ACT_CTX)), mesh_fn=None, abstract_args=(), arg_specs=(),
        model_flops=1.0)
    mesh = make_host_mesh("cpu")
    bundle.get_fn()()
    bundle.get_fn(mesh, SH.FSDP_TP)()
    assert seen == [[], [(SH.FSDP_TP, mesh)]]
