"""The port's NequIP (``repro_torch.models.gnn.nequip``) against the
reference (``repro.models.gnn.nequip``) on the CPU, in float32, with the
reference's ``init_params`` carried across by ``load_reference_params``:
``forward`` (graph energies and node irreps) and ``node_forward`` within
rtol 1e-4 and atol 1e-5 at ``SMOKE`` width and at ``CONFIG`` width
(l_max 2, 15 paths) with 2 layers, on the EGNN tests' two-graph batch
with a padded edge and an isolated node; the Bessel basis (at r = 0 and
past the cutoff) and the depthwise tensor product on their own.

The reference's features are float64 from its first aggregation on
(its ``/ np.sqrt(avg_degree)`` promotes under the package's x64 flag);
the port's stay float32, and the tolerance holds all the same."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nequip as JC
from repro.models.gnn import nequip as JN
from repro_torch.configs import nequip as TC
from repro_torch.models.gnn.nequip import NequIP, bessel_rbf
from tests.test_torch_egnn import graph_pair

TOL = dict(rtol=1e-4, atol=1e-5)


def configs(which):
    if which == "smoke":
        return TC.SMOKE, JC.SMOKE
    return (dataclasses.replace(TC.CONFIG, n_layers=2),
            dataclasses.replace(JC.CONFIG, n_layers=2))


def close(got, want, **tol):
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_forward_and_node_forward_match_reference(which):
    mine, ref = configs(which)
    jb, tb = graph_pair(mine.d_in, seed=2)
    params = JN.init_params(ref, jax.random.PRNGKey(5))
    model = NequIP(mine, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        g, h = model(tb)
        node = model.node_forward(tb)
    jg, jh = JN.forward(params, jb, ref)
    assert g.dtype == h.dtype == torch.float32
    assert tuple(h.shape) == (13, mine.d_hidden, mine.comps)
    close(g, jg)
    close(h, jh)
    close(node, JN.node_forward(params, jb, ref))


def test_bessel_basis_and_tensor_product_match_reference():
    r = np.array([0.0, 1e-12, 0.3, 1.7, 4.99, 5.0, 7.5], np.float32)
    close(bessel_rbf(torch.from_numpy(r), 8, 5.0),
          JN.bessel_rbf(jnp.asarray(r), 8, 5.0), rtol=1e-5, atol=1e-6)
    mine, ref = TC.CONFIG, JC.CONFIG
    assert mine.paths == ref.paths and len(mine.paths) == 15
    assert mine.comps == ref.comps == 9
    rng = np.random.default_rng(4)
    e, c = 10, mine.d_hidden
    h_src = rng.standard_normal((e, c, 9)).astype(np.float32)
    Y = rng.standard_normal((e, 9)).astype(np.float32)
    w = rng.standard_normal((e, 15, c)).astype(np.float32)
    layer = NequIP(dataclasses.replace(mine, n_layers=1),
                   device="cpu").layers[0]
    got = layer.tensor_product(torch.from_numpy(h_src), torch.from_numpy(Y),
                               torch.from_numpy(w))
    close(got, JN._tensor_product(ref, jnp.asarray(h_src), jnp.asarray(Y),
                                  jnp.asarray(w)), rtol=1e-5, atol=1e-5)


def test_config_and_errors():
    for mine, ref in ((TC.CONFIG, JC.CONFIG), (TC.SMOKE, JC.SMOKE)):
        got, want = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want
    tree = jax.tree.map(np.asarray, JN.init_params(JC.SMOKE))
    with pytest.raises(ValueError, match="layers"):
        NequIP(TC.CONFIG, device="cpu").load_reference_params(tree)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NequIP(TC.SMOKE)
