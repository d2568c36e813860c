"""The ring-partitioned Equiformer-v2 (``repro_torch.models.gnn.ring``)
against the reference's (``repro.models.gnn.ring``) on the CPU:

* ``bucket_edges`` (also at a ``cap`` below the fullest bucket, with its
  ``dropped`` count), ``blocked_layout``, ``bucket_specs``' shapes and
  ``_shift_perm`` equal the reference's exactly;
* ``forward_ring`` over CPU meshes (2, 2), (3, 1) and (1, 2) gives the
  reference's local ``equiformer_v2.forward`` node irreps within rtol
  1e-4 / atol 1e-5, with carried weights, as
  ``tests/launch/ring_check.py`` holds the reference's ring to its local
  path;
* the gradient of a scalar loss through the ring equals the port's
  local gradient within rtol 1e-4 / atol 1e-5, for every parameter.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models.gnn import equiformer_v2 as E2
from repro.models.gnn import ring as JR
from repro.models.gnn.graph import from_numpy as jax_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import equiformer_v2 as T2
from repro_torch.models.gnn import ring as RG
from repro_torch.models.gnn.graph import from_numpy

KW = dict(d_in=6, n_layers=2, d_hidden=8, l_max=2, m_max=1, n_heads=2,
          n_rbf=8)


def graph(seed=0, n=24, e=70):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    keep = snd != rcv
    return feat, pos, snd[keep], rcv[keep]


@pytest.mark.parametrize("p_data,p_model,cap", [
    (2, 2, None), (3, 1, None), (1, 2, None), (4, 3, None), (2, 2, 3),
    (3, 2, 1)])
def test_bucket_edges_equal_the_references(p_data, p_model, cap):
    feat, pos, snd, rcv = graph(1, n=31, e=120)
    want = JR.bucket_edges(snd, rcv, 31, p_data, p_model, cap)
    got = RG.bucket_edges(snd, rcv, 31, p_data, p_model, cap)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    if cap is not None:
        assert got[3] > 0
    blocked, wpos, n_loc = JR.blocked_layout(feat, pos, 31, p_data)
    mine = RG.blocked_layout(feat, pos, 31, p_data)
    np.testing.assert_array_equal(mine[0], blocked)
    np.testing.assert_array_equal(mine[1], wpos)
    assert mine[2] == n_loc == got[2]
    back = RG.unblock(torch.from_numpy(mine[0]), 31, p_data).numpy()
    np.testing.assert_array_equal(back, feat)


@pytest.mark.parametrize("n,e,p_data,p_model", [(2708, 10752, 2, 2),
                                                (100, 7, 4, 16)])
def test_bucket_specs_and_shift_perm_equal_the_references(n, e, p_data,
                                                          p_model):
    js, jd, jn = JR.bucket_specs(n, e, p_data, p_model)
    ts, td, tn = RG.bucket_specs(n, e, p_data, p_model)
    assert tuple(ts.shape) == js.shape and tuple(td.shape) == jd.shape
    assert ts.dtype == torch.int32 and tn == jn
    for s in range(p_data):
        assert RG._shift_perm(p_data, s) == JR._shift_perm(p_data, s)
        for d in range(p_data):
            assert RG._source_block(d, s, p_data) == (d - s) % p_data


def models():
    jcfg = E2.EquiformerV2Config(**KW)
    params = E2.init_params(jcfg, jax.random.PRNGKey(0))
    model = T2.EquiformerV2(T2.EquiformerV2Config(**KW), device="cpu")
    return jcfg, params, model.load_reference_params(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("p_data,p_model", [(2, 2), (3, 1), (1, 2)])
def test_forward_ring_matches_the_references_local_forward(p_data, p_model):
    jcfg, params, model = models()
    feat, pos, snd, rcv = graph()
    n = feat.shape[0]
    _, want = E2.forward(params, jax_from_numpy(feat, snd, rcv, pos=pos),
                         jcfg)
    want = np.asarray(want[:n])
    src_b, dst_b, _, dropped = RG.bucket_edges(snd, rcv, n, p_data, p_model)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, n, p_data)
    mesh = make_mesh((p_data, p_model), ("data", "model"),
                     ["cpu"] * (p_data * p_model))
    with torch.no_grad():
        x = RG.forward_ring(model, torch.from_numpy(nodes),
                            torch.from_numpy(pblk), src_b, dst_b, mesh)
    assert dropped == 0 and x.shape[0] == nodes.shape[0]
    np.testing.assert_allclose(RG.unblock(x, n, p_data).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_ring_gradient_matches_the_local_gradient():
    _, _, model = models()
    feat, pos, snd, rcv = graph(2)
    n = feat.shape[0]
    src_b, dst_b, _, _ = RG.bucket_edges(snd, rcv, n, 2, 2)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, n, 2)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = RG.forward_ring(model, torch.from_numpy(nodes),
                        torch.from_numpy(pblk), src_b, dst_b, mesh)
    params = list(model.parameters())
    ring = torch.autograd.grad((RG.unblock(x, n, 2)[..., 0] ** 2).sum(),
                               params, allow_unused=True)
    _, local_x = model(from_numpy(feat, snd, rcv, pos=pos, device="cpu"))
    local = torch.autograd.grad((local_x[:n, :, 0] ** 2).sum(), params,
                                allow_unused=True)
    # the head reads no node irreps: no gradient on either path
    assert [g is None for g in ring] == [g is None for g in local]
    pairs = [(name, a, b) for (name, _), a, b in
             zip(model.named_parameters(), ring, local) if a is not None]
    assert sum(float(a.abs().sum()) for _, a, _ in pairs) > 0
    for name, a, b in pairs:
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_ring_needs_a_data_model_mesh():
    _, _, model = models()
    feat, pos, snd, rcv = graph()
    src_b, dst_b, _, _ = RG.bucket_edges(snd, rcv, 24, 2, 2)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, 24, 2)
    with pytest.raises(ValueError, match="mesh"):
        RG.forward_ring(model, torch.from_numpy(nodes),
                        torch.from_numpy(pblk), src_b, dst_b,
                        make_mesh((4,), ("model",), ["cpu"] * 4))
