"""The port's EGNN (``repro_torch.models.gnn.egnn``) against the
reference (``repro.models.gnn.egnn``) on the CPU, in float32, with the
reference's ``init_params`` carried across by ``load_reference_params``:
``forward`` (graph outputs, node features and coordinates) and
``node_forward`` within rtol 1e-4 and atol 1e-5, at ``SMOKE`` width and
at ``CONFIG`` width with 2 layers, on a batch of two graphs of 12 nodes
in all with a padded edge slot and an isolated node (:func:`graph_pair`,
shared by the NequIP and Equiformer-v2 tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as JC
from repro.models.gnn import egnn as JE
from repro.models.gnn import graph as JG
from repro_torch.configs import egnn as TC
from repro_torch.models.gnn import graph as TG
from repro_torch.models.gnn.egnn import EGNN

TOL = dict(rtol=1e-4, atol=1e-5)


def graph_pair(d_in: int, seed: int = 0):
    """The same batch in both packages: 12 nodes in two graphs (0-5,
    6-11), random edges within each graph, node 11 isolated, 2 padded
    edge slots, positions N(0, 1.5^2)."""
    r = np.random.default_rng(seed)
    n, e = 12, 30
    gid = (np.arange(n) >= 6).astype(np.int32)
    s = r.integers(0, 11, e).astype(np.int32)
    t = r.integers(0, 11, e).astype(np.int32)
    keep = (gid[s] == gid[t]) & (s != t)
    kw = dict(pos=(1.5 * r.standard_normal((n, 3))).astype(np.float32),
              graph_id=gid, n_graph=2, e_cap=int(keep.sum()) + 2)
    feats = r.standard_normal((n, d_in)).astype(np.float32)
    jb = JG.from_numpy(feats, s[keep], t[keep], **kw)
    tb = TG.from_numpy(feats, s[keep], t[keep], device="cpu", **kw)
    assert 11 not in s[keep] and 11 not in t[keep]
    assert not bool(tb.edge_mask[-2:].any())
    return jb, tb


def configs(which):
    """(the port's config, the reference's) at ``which``: SMOKE, or
    CONFIG with its layers cut to 2."""
    if which == "smoke":
        return TC.SMOKE, JC.SMOKE
    return (dataclasses.replace(TC.CONFIG, n_layers=2),
            dataclasses.replace(JC.CONFIG, n_layers=2))


def close(got, want):
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_forward_and_node_forward_match_reference(which):
    mine, ref = configs(which)
    jb, tb = graph_pair(mine.d_in, seed=1)
    params = JE.init_params(ref, jax.random.PRNGKey(3))
    model = EGNN(mine, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(tb)
        node = model.node_forward(tb)
    want = JE.forward(params, jb, ref)
    assert tuple(got[0].shape) == (2, 1)
    for g, w in zip(got, want):
        close(g, w)
    close(node, JE.node_forward(params, jb, ref))
    assert tuple(node.shape) == (12, 1)


def test_config_layout_and_errors():
    for mine, ref in ((TC.CONFIG, JC.CONFIG), (TC.SMOKE, JC.SMOKE)):
        got, want = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want
    model = EGNN(TC.SMOKE, device="cpu")
    h = TC.SMOKE.d_hidden
    assert model.layers[0].phi_e.layers[0].w.shape == (2 * h + 1, h)  # [in, out]
    again = EGNN(TC.SMOKE, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))
    tree = jax.tree.map(np.asarray, JE.init_params(JC.CONFIG))
    with pytest.raises(ValueError, match="layers"):
        model.load_reference_params(tree)
    with pytest.raises(ValueError, match="does not fit"):
        EGNN(dataclasses.replace(TC.SMOKE, n_layers=4),
             device="cpu").load_reference_params(tree)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EGNN(TC.SMOKE)
