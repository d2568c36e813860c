"""The port's GNN substrate and PNA (``repro_torch.models.gnn``) against
the reference (``repro.models.gnn``) on the CPU.

Segment ops (empty segments and the pad row included) and graph batches
compare in float32 within rtol 1e-6; the PNA forward, with the
reference's parameters carried across, within rtol 1e-4 and atol 1e-5
at the ``configs/pna.py`` CONFIG width (4 layers, d_hidden 75) and at
SMOKE width: float32 throughout, and the two frameworks sum in other
orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.pna import CONFIG as JAX_CONFIG
from repro.configs.pna import SMOKE as JAX_SMOKE
from repro.models.gnn import graph as JG
from repro.models.gnn import pna as JP
from repro_torch.configs.pna import CONFIG, SMOKE
from repro_torch.models.common import dense_init
from repro_torch.models.gnn import graph as TG
from repro_torch.models.gnn.pna import PNA


def random_batch(n, e, f, seed, *, n_graph=1, e_pad=5, isolated=3):
    """Features, edges (the last ``isolated`` nodes receive nothing) and
    optional graph ids, as numpy."""
    r = np.random.default_rng(seed)
    feats = r.standard_normal((n, f)).astype(np.float32)
    senders = r.integers(0, n, e).astype(np.int32)
    receivers = r.integers(0, n - isolated, e).astype(np.int32)
    gid = np.sort(r.integers(0, n_graph, n)).astype(np.int32)
    return feats, senders, receivers, gid, e + e_pad


def both_batches(feats, senders, receivers, gid, e_cap, n_graph):
    kw = dict(graph_id=gid, n_graph=n_graph, e_cap=e_cap)
    return (JG.from_numpy(feats, senders, receivers, **kw),
            TG.from_numpy(feats, senders, receivers, device="cpu", **kw))


def test_from_numpy_matches_reference():
    feats, s, r, gid, e_cap = random_batch(9, 20, 3, 0, n_graph=2)
    pos = np.random.default_rng(1).standard_normal((9, 3)).astype(np.float32)
    jb = JG.from_numpy(feats, s, r, pos=pos, graph_id=gid, n_graph=2,
                       e_cap=e_cap)
    tb = TG.from_numpy(feats, s, r, pos=pos, graph_id=gid, n_graph=2,
                       e_cap=e_cap, device="cpu")
    for name in ("nodes", "senders", "receivers", "pos", "graph_id"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    assert (tb.n_node, tb.n_graph, tb.n_edge) == (jb.n_node, jb.n_graph,
                                                 jb.n_edge)
    np.testing.assert_array_equal(tb.node_mask.numpy(),
                                  np.asarray(jb.node_mask))
    np.testing.assert_array_equal(tb.edge_mask.numpy(),
                                  np.asarray(jb.edge_mask))
    with pytest.raises(ValueError):
        TG.from_numpy(feats, s, r, e_cap=3, device="cpu")


def test_segment_ops_match_reference_with_empty_segments():
    r = np.random.default_rng(2)
    n_rows, e, d = 12, 40, 5
    msgs = r.standard_normal((e, d)).astype(np.float32)
    recv = r.integers(0, n_rows - 4, e).astype(np.int64)   # 4 empty rows
    recv[-3:] = n_rows - 1                          # pad slots -> dump row
    jm, jr = jnp.asarray(msgs), jnp.asarray(recv.astype(np.int32))
    tm, tr = torch.from_numpy(msgs), torch.from_numpy(recv)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    close(TG.agg_sum(tm, tr, n_rows), JG.agg_sum(jm, jr, n_rows))
    for got, want in zip(TG.agg_mean(tm, tr, n_rows),
                         JG.agg_mean(jm, jr, n_rows)):
        close(got, want)
    for got, want in zip(TG.agg_std(tm, tr, n_rows),
                         JG.agg_std(jm, jr, n_rows)):
        close(got, want)
    for op in ("agg_max", "agg_min"):
        got = getattr(TG, op)(tm, tr, n_rows)
        want = np.asarray(getattr(JG, op)(jm, jr, n_rows))
        assert np.isinf(want[n_rows - 4:n_rows - 1]).all()   # empty rows
        np.testing.assert_array_equal(got.numpy(), want)
    close(TG.degrees(tr, n_rows), JG.degrees(jr, n_rows))
    gid = np.asarray([0, 0, 1, 1, 1, 3, 3, 2, 2, 0, 1, 3], np.int64)
    for op in ("sum", "mean"):
        close(TG.graph_readout(torch.from_numpy(msgs[:12]),
                               torch.from_numpy(gid), 3, op),
              JG.graph_readout(jnp.asarray(msgs[:12]),
                               jnp.asarray(gid.astype(np.int32)), 3, op))
    with pytest.raises(ValueError):
        TG.graph_readout(tm[:12], torch.from_numpy(gid), 3, "max")


@pytest.mark.parametrize("which,node_level", [
    ("CONFIG", True), ("SMOKE", True), ("SMOKE", False)],
    ids=["CONFIG-node", "SMOKE-node", "SMOKE-graph"])
def test_forward_with_carried_weights(which, node_level):
    mine = dataclasses.replace({"CONFIG": CONFIG, "SMOKE": SMOKE}[which],
                               d_in=4, node_level=node_level)
    ref = dataclasses.replace({"CONFIG": JAX_CONFIG, "SMOKE": JAX_SMOKE}[which],
                              d_in=4, node_level=node_level)
    feats, s, r, gid, e_cap = random_batch(30, 90, 4, 3, n_graph=3)
    jb, tb = both_batches(feats, s, r, gid, e_cap, 3)
    params = JP.init_params(ref, jax.random.PRNGKey(7))
    want = np.asarray(JP.forward(params, jb, ref))
    model = PNA(mine, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(tb).numpy()
    assert got.shape == want.shape == ((30, 1) if node_level else (3, 1))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_configs_and_weight_layout():
    for mine, ref in ((CONFIG, JAX_CONFIG), (SMOKE, JAX_SMOKE)):
        got = dataclasses.asdict(mine)
        want = dataclasses.asdict(ref)
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want
    assert (CONFIG.n_layers, CONFIG.d_hidden) == (4, 75)
    model = PNA(CONFIG, device="cpu")
    h = CONFIG.d_hidden
    assert model.layers[0].msg.weight.shape == (h, 2 * h)   # [out, in]
    assert model.layers[0].upd.weight.shape == (h, 13 * h)
    again = PNA(CONFIG, generator=torch.Generator().manual_seed(0),
                device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))
    w = dense_init(400, 3, generator=torch.Generator().manual_seed(1))
    assert w.shape == (400, 3) and abs(float(w.std()) - 0.05) < 0.01
    params = JP.init_params(dataclasses.replace(JAX_SMOKE, d_in=4))
    with pytest.raises(ValueError, match="layers"):
        PNA(CONFIG, device="cpu").load_reference_params(
            jax.tree.map(np.asarray, params))
    with pytest.raises(ValueError, match="does not fit"):
        PNA(dataclasses.replace(SMOKE, d_in=5),
            device="cpu").load_reference_params(
                jax.tree.map(np.asarray, params))
