"""The port's Equiformer-v2 (``repro_torch.models.gnn.equiformer_v2``)
against the reference (``repro.models.gnn.equiformer_v2``) on the CPU,
in float32, with the reference's ``init_params`` carried across by
``load_reference_params``:

* ``forward`` (graph outputs and node irreps) and ``node_forward``
  within rtol 1e-4 and atol 1e-5, at ``SMOKE`` width and at ``CONFIG``
  width (l_max 6, m_max 2, 8 heads, 128 channels) with 2 layers, on the
  EGNN tests' two-graph batch with a padded edge and an isolated node;
  the reference runs once per configuration (a module-scoped fixture);
* one layer's ``edge_messages`` at ``CONFIG`` width, on edges that
  include the polar axis and zero length; the RBF centres, the
  m-truncated representation both ways, the per-head weighting
  (``repeat_interleave``) and the segment softmax, whose dump row
  receives only masked edges and must come out 0, not NaN;
* the port's own invariance under a rotation of the positions, which
  the planted fault (messages rotated back with ``Ds``, not their
  transposes) breaks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as JC
from repro.models.gnn import equiformer_v2 as JQ
from repro_torch.configs import equiformer_v2 as TC
from repro_torch.models.gnn import equiformer_v2 as TQ
from repro_torch.models.gnn.graph import GraphBatch
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


@pytest.fixture(scope="module")
def reference():
    """{which: (batch pair, params tree, forward's (g, x), node_forward)}
    from the reference, computed once."""
    out = {}
    for which in ("smoke", "config"):
        _, ref = configs(which)
        jb, tb = graph_pair(ref.d_in, seed=3)
        params = JQ.init_params(ref, jax.random.PRNGKey(11))
        g, x = JQ.forward(params, jb, ref)
        node = JQ.node_forward(params, jb, ref)
        out[which] = ((jb, tb), params, (np.asarray(g), np.asarray(x)),
                      np.asarray(node))
    return out


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_forward_and_node_forward_match_reference(reference, which):
    mine, _ = configs(which)
    (_, tb), params, want, want_node = reference[which]
    model = TQ.EquiformerV2(mine, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        g, x = model(tb)
        node = model.node_forward(tb)
    assert tuple(x.shape) == (13, mine.d_hidden, mine.comps)
    close(g, want[0])
    close(x, want[1])
    close(node, want_node)


def test_edge_messages_match_reference(reference):
    mine, ref = configs("config")
    _, params, _, _ = reference["config"]
    lp = params["layers"][0]
    model = TQ.EquiformerV2(mine, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(6)
    e, c, k = 7, mine.d_hidden, mine.comps
    xs = rng.standard_normal((e, c, k)).astype(np.float32)
    xd = rng.standard_normal((e, c, k)).astype(np.float32)
    rel = rng.standard_normal((e, 3)).astype(np.float32)
    rel[0] = 0.0                          # a padded edge
    rel[1] = [0.0, 0.0, 2.0]              # on the polar axis
    rel[2] = [-3.0, 0.2, 0.1]             # the other helper axis
    with torch.no_grad():
        msg, alpha = TQ.edge_messages(model.layers[0], torch.from_numpy(xs),
                                      torch.from_numpy(xd),
                                      torch.from_numpy(rel), mine)
    jmsg, jalpha = JQ.edge_messages(lp, jnp.asarray(xs), jnp.asarray(xd),
                                    jnp.asarray(rel), ref)
    close(msg, jmsg)
    close(alpha, jalpha)


def test_pieces_match_reference():
    mine, ref = TC.CONFIG, JC.CONFIG
    r = np.array([0.0, 0.05, 1.3, 4.9, 6.0], np.float32)
    close(TQ.gaussian_rbf(torch.from_numpy(r), 64, 5.0),
          JQ.gaussian_rbf(jnp.asarray(r), 64, 5.0), rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4, mine.comps)).astype(np.float32)
    idx = TQ.MIndex(mine, "cpu")
    m0, pairs = TQ.to_m_rep(mine, torch.from_numpy(x), idx)
    jm0, jpairs = JQ.to_m_rep(ref, jnp.asarray(x))
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jm0))
    for (a, b), (ja, jb) in zip(pairs, jpairs, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    back = TQ.from_m_rep(mine, m0, pairs, x.shape, idx)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JQ.from_m_rep(ref, jm0, jpairs,
                                               jnp.asarray(x))))
    # head h scales channels [h C/H, (h + 1) C/H): repeat_interleave
    small = dataclasses.replace(mine, d_hidden=8, n_heads=2)
    alpha = np.array([[2.0, 3.0]], np.float32)
    msg = np.ones((1, 8, 2), np.float32)
    got = TQ.head_weight(torch.from_numpy(alpha), torch.from_numpy(msg),
                         small)
    np.testing.assert_array_equal(got[0, :, 0].numpy(), [2] * 4 + [3] * 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.head_weight(jnp.asarray(alpha),
                                               jnp.asarray(msg), small)))


def test_segment_softmax_gives_the_dump_row_zero():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((9, 3)).astype(np.float32) * 4
    seg = np.array([0, 0, 1, 1, 1, 3, 4, 4, 4])     # row 2 gets nothing
    mask = np.array([1, 1, 1, 1, 0, 1, 0, 0, 0], bool)   # row 4: dump row
    got = TQ._segment_softmax(torch.from_numpy(logits), torch.from_numpy(seg),
                              5, torch.from_numpy(mask))
    want = JQ._segment_softmax(jnp.asarray(logits),
                               jnp.asarray(seg.astype(np.int32)), 5,
                               jnp.asarray(mask))
    close(got, want, rtol=1e-6, atol=1e-7)
    assert (got[~torch.from_numpy(mask)] == 0).all()
    sums = torch.zeros(5, 3).index_add_(0, torch.from_numpy(seg), got)
    torch.testing.assert_close(sums[[0, 1, 3]], torch.ones(3, 3))


def test_rotation_invariance_and_the_planted_fault(monkeypatch):
    """The port's outputs stay put when the positions rotate; rotating
    the messages back with ``Ds`` in place of ``DsT`` breaks that (phase
    G's planted fault)."""
    mine = dataclasses.replace(TC.SMOKE, n_layers=3)
    _, tb = graph_pair(mine.d_in, seed=4)
    q, _ = np.linalg.qr(np.random.default_rng(5).standard_normal((3, 3)))
    q[:, 0] *= np.sign(np.linalg.det(q))
    rot = dataclasses.replace(
        tb, pos=tb.pos @ torch.from_numpy(q.T.astype(np.float32)))
    model = TQ.EquiformerV2(mine, generator=torch.Generator().manual_seed(2),
                            device="cpu")

    def moved():
        with torch.no_grad():
            a, b = model.node_forward(tb), model.node_forward(rot)
        return float((b - a).norm() / a.norm())
    assert moved() < 1e-5
    monkeypatch.setattr(TQ, "inverse_wigner", lambda Ds: Ds)
    assert moved() > 1e-2


def test_config_and_errors():
    for mine, ref in ((TC.CONFIG, JC.CONFIG), (TC.SMOKE, JC.SMOKE)):
        got, want = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want
        assert [mine.n_l(m) for m in range(mine.m_max + 1)] == \
            [ref.n_l(m) for m in range(ref.m_max + 1)]
    tree = jax.tree.map(np.asarray, JQ.init_params(JC.SMOKE))
    with pytest.raises(ValueError, match="layers"):
        TQ.EquiformerV2(dataclasses.replace(TC.SMOKE, n_layers=1),
                        device="cpu").load_reference_params(tree)
    assert isinstance(graph_pair(4)[1], GraphBatch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TQ.EquiformerV2(TC.SMOKE)
