"""The port's step bundles of the GNN family (EGNN, PNA, NequIP,
Equiformer-v2) against the reference's on the CPU.

* Every GNN smoke cell of ``tests/configs/test_smoke.py`` (four
  architectures x full_graph_sm, minibatch_lg, ogb_products, molecule):
  the reference's ``make_host_args`` output through its jitted AdamW
  step and, carried across by ``load_reference_args``, through the
  port's.  The reference's updated parameters and moments are carried
  into the port's layout (by parameter name) the same way; the loss,
  the grad norm, every updated parameter and both moments (the
  gradients) agree within rtol 1e-4 / atol 1e-5, the port's GNN
  tolerance; ``lr``, ``skipped`` and the step exactly.  One cell is ill
  conditioned in float32 in both packages: PNA at molecule, whose
  graphs leave most nodes of degree 0 or 1, where the std aggregator is
  ``sqrt(clamp(E[x^2] - E[x]^2, 0) + 1e-9)`` of a variance that is zero
  up to rounding, and whose gradient (1 / (2 sqrt(1e-9)) times that
  rounding, or 0 where it clamps) is noise.  The reference's own
  float32 moments sit up to a relative L2 of 7.9e-3 (mu) and 1.49e-2
  (nu, the squared gradient) from its float64 ones there
  (``layers.0.msg.weight``), so that cell's float32 moments are held
  within 1e-2 (mu) and 2e-2 (nu) a leaf of the reference's, and the
  same cell in float64 (both packages' bundle builders on the SMOKE
  config in float64) within rtol 1e-4 / atol 1e-5.
* The ring variant of Equiformer-v2: abstract as the reference's, and
  its step at a small config on a (2, 1) CPU mesh equal to a step of the
  same loss over the local ``node_forward`` (rtol 1e-4 / atol 1e-5).
* Every GNN cell at full size: the abstract arguments lie on the meta
  device, ``model_flops`` equals the reference's exactly, the
  ``GraphBatch`` and labels have its shapes and dtypes (the port's
  graph indices int64 where the reference's are int32), and the
  parameters and AdamW state its element counts (the port's parameters
  are its modules' ``named_parameters()``, the reference's a tree)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.launch import steps as RS
from repro_torch.configs import get
from repro_torch.launch import steps as S
from tests.test_torch_launch_lm import (assert_full_size_cell, cells_of,
                                        host, ids, numel, rel_l2,
                                        run_both)

TOL = dict(rtol=1e-4, atol=1e-5)
GNN = cells_of("gnn")
#: (module doc) the float32 moments of PNA at molecule, a leaf
PNA_MOLECULE_REL_L2 = {"mu": 1e-2, "nu": 2e-2}


def as_port_layout(arch, shape, want, ref_args):
    """The reference's updated parameters and state in the port's layout
    (by parameter name), through ``load_reference_args``."""
    params, state, _ = S.load_reference_args(
        arch, shape, (want[0], want[1], ref_args[2]), device="cpu")
    return params, state


@pytest.mark.parametrize("arch,shape", GNN, ids=ids(GNN))
def test_gnn_smoke_cell_matches_reference(arch, shape):
    want, got, got_args, ref_args = run_both(arch, shape)
    params, state, stats = got
    w_params, w_state = as_port_layout(arch, shape, want, ref_args)
    assert params.keys() == w_params.keys() == got_args[0].keys()
    ill = (arch, shape) == ("pna", "molecule")
    for name in params:
        np.testing.assert_allclose(host(params[name]), host(w_params[name]),
                                   err_msg=name, **TOL)
        for moment in ("mu", "nu"):
            g = getattr(state, moment)[name]
            w = getattr(w_state, moment)[name]
            if ill:
                assert rel_l2(host(g), host(w)) <= \
                    PNA_MOLECULE_REL_L2[moment], (moment, name)
            else:
                np.testing.assert_allclose(host(g), host(w), err_msg=name,
                                           **TOL)
    assert int(state.step) == int(want[1].step) == 1
    assert stats.keys() == want[2].keys()
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(stats[k]), float(want[2][k]),
                                   err_msg=k, **TOL)
    for k in ("lr", "skipped"):
        assert float(stats[k]) == float(want[2][k]), k


def test_pna_molecule_cell_in_float64_matches_reference(monkeypatch):
    """The ill-conditioned cell (module doc) in float64: every moment
    within the GNN tolerance."""
    arch, shape = "pna", "molecule"
    jspec, tspec = jax_get(arch), get(arch)
    jspec = dataclasses.replace(jspec, smoke=dataclasses.replace(
        jspec.smoke, dtype=jnp.float64))
    tspec = dataclasses.replace(tspec, smoke=dataclasses.replace(
        tspec.smoke, dtype=torch.float64))
    args = jax.tree.map(lambda x: x.astype(jnp.float64)
                        if x.dtype == jnp.float32 else x,
                        RS.make_host_args(arch, shape))
    want = jax.tree.map(np.asarray, jax.jit(RS.gnn_bundle(
        jspec, jspec.shapes[shape], True).get_fn())(*args))
    monkeypatch.setattr(S, "get_arch", lambda _: tspec)
    ref_args = jax.tree.map(np.asarray, args)
    got_args = S.load_reference_args(arch, shape, ref_args, device="cpu")
    assert got_args[0]["embed.weight"].dtype == torch.float64
    params, state, stats = S.gnn_bundle(tspec, tspec.shapes[shape],
                                        True).get_fn()(*got_args)
    w_params, w_state = as_port_layout(arch, shape, want, ref_args)
    for name in params:
        for g, w in ((params[name], w_params[name]),
                     (state.mu[name], w_state.mu[name]),
                     (state.nu[name], w_state.nu[name])):
            np.testing.assert_allclose(host(g), host(w), err_msg=name,
                                       **TOL)
    np.testing.assert_allclose(float(stats["loss"]), float(want[2]["loss"]),
                               **TOL)


@pytest.mark.parametrize("arch,shape", GNN, ids=ids(GNN))
def test_gnn_full_size_cell_is_abstract_and_sized_as_reference(arch, shape):
    int_map = {f"/0/{f}": torch.int64
               for f in ("senders", "receivers", "graph_id")}
    got, want = assert_full_size_cell(arch, shape, (2,), int_map)
    assert numel(got.abstract_args[0]) == numel(want.abstract_args[0])
    assert numel(got.abstract_args[1]) == numel(want.abstract_args[1])
    # the abstract batch keeps the reference's static sizes
    for g, w in ((got.abstract_args[2][0], want.abstract_args[2][0]),):
        assert (g.n_node, g.n_graph) == (w.n_node, w.n_graph)
    assert set(got.arg_specs[0].values()) == {()}


def test_ring_bundle_is_abstract_and_sized_as_reference():
    """The ring variant of Equiformer-v2 at full_graph_sm and
    ogb_products: meta leaves, the reference's buckets, node blocks and
    ``model_flops``."""
    for shape in ("full_graph_sm", "ogb_products"):
        got = S.make_bundle("equiformer-v2", shape, variant="ring")
        want = RS.make_bundle("equiformer-v2", shape, variant="ring")
        assert got.name == want.name
        assert got.model_flops == want.model_flops
        assert got.mesh_fn is not None and got.fn is None
        for g, w in zip(got.abstract_args[2], want.abstract_args[2]):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
        assert numel(got.abstract_args[0]) == numel(want.abstract_args[0])
        assert got.arg_specs[2] == want.arg_specs[2]
    with pytest.raises(ValueError, match="ring"):
        S.make_bundle("egnn", "full_graph_sm", variant="ring")
    assert get("equiformer-v2").family == "gnn"


def test_ring_bundle_step_equals_the_local_step():
    """The ring bundle's step (``mesh_fn``) at a small Equiformer-v2 on a
    (2, 1) CPU mesh: its loss, grad norm and updated parameters equal a
    step of the same cross-entropy over the local ``node_forward``."""
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import softmax_cross_entropy
    from repro_torch.models.gnn import ring as RG
    from repro_torch.models.gnn.equiformer_v2 import (EquiformerV2,
                                                      EquiformerV2Config)
    from repro_torch.models.gnn.graph import from_numpy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step_fn
    cfg = EquiformerV2Config(d_in=6, n_layers=2, d_hidden=8, l_max=2,
                             m_max=1, n_heads=2, n_rbf=8)
    spec = dataclasses.replace(get("equiformer-v2"), config=cfg)
    n, e, classes = 24, 70, 3
    shape = ShapeSpec("tiny", "full_graph", dict(
        n_nodes=n, n_edges=e, d_feat=6, n_classes=classes))
    bundle = S.equiformer_ring_bundle(spec, shape, p_data=2, p_model=1)
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd, rcv = (rng.integers(0, n, e).astype(np.int32) for _ in range(2))
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    labels = rng.integers(0, classes, n).astype(np.int32)
    cap = bundle.abstract_args[2][2].shape[-1]
    src_b, dst_b, n_loc, dropped = RG.bucket_edges(snd, rcv, n, 2, 1, cap)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, n, 2)
    lblk = np.full(2 * (n_loc + 1), -1, np.int32)     # -1 on pad rows
    for blk in range(2):
        lo, hi = blk * n_loc, min((blk + 1) * n_loc, n)
        lblk[blk * (n_loc + 1):blk * (n_loc + 1) + hi - lo] = labels[lo:hi]
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in
                  (nodes, pblk, src_b, dst_b, lblk))
    assert dropped == 0
    for g, w in zip(batch, bundle.abstract_args[2]):
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
    model = EquiformerV2(dataclasses.replace(cfg, n_out=classes),
                         device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    assert params.keys() == bundle.abstract_args[0].keys()
    state = opt.init(params, opt.AdamWConfig())
    mesh = make_mesh((2, 1), ("data", "model"), ["cpu"] * 2)
    got = bundle.get_fn(mesh)(params, state, batch)

    local = from_numpy(feat, snd, rcv, pos=pos, device="cpu")

    def local_loss(p, b):
        logits = torch.func.functional_call(
            S._Method(model, "node_forward"),
            {f"m.{k}": v for k, v in p.items()}, (b[0],))
        return softmax_cross_entropy(logits, b[1])

    want = make_train_step_fn(local_loss, opt.AdamWConfig())(
        params, state, (local, torch.from_numpy(labels)))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   err_msg=k, **TOL)
    for name in params:
        np.testing.assert_allclose(host(got[0][name]), host(want[0][name]),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(host(got[1].mu[name]),
                                   host(want[1].mu[name]), err_msg=name,
                                   **TOL)
