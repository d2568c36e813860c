"""The ring-partitioned Equiformer-v2 (``repro_torch.models.gnn.ring``)
against the reference's (``repro.models.gnn.ring``) on the CPU:

* ``bucket_edges`` (also at a ``cap`` below the fullest bucket, with its
  ``dropped`` count), ``blocked_layout``, ``bucket_specs``' shapes and
  ``_shift_perm`` equal the reference's exactly;
* ``forward_ring`` over CPU meshes (2, 2), (3, 1), (2, 1) and (1, 2)
  gives the reference's local ``equiformer_v2.forward`` node irreps
  within rtol 1e-4 / atol 1e-5, with carried weights, as
  ``tests/launch/ring_check.py`` holds the reference's ring to its local
  path; its output is node blocks placed over ``data``, and given its
  inputs already so placed (the buckets over ``("data", "model")``) it
  gives the same irreps bit for bit;
* no operation of ``forward_ring`` makes a tensor of all the nodes' rows
  (the node state stays in blocks);
* the ring bundle at ``ogb_products`` laid out over meta meshes (4, 1)
  and (2, 2) by its ``arg_specs``: node blocks over ``data`` and the
  buckets over ``("data", "model")``, their bytes a device, nothing
  allocated;
* the gradient of a scalar loss through the ring equals the port's
  local gradient within rtol 1e-4 / atol 1e-5, for every parameter;
* a float64 module runs the ring with float64 accumulators: its node
  irreps equal the port's float64 local forward within 1e-7 relative,
  far inside what float32 resolves (the local softmax's ``+ 1e-9`` on
  its denominator is the one term the two do not share).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models.gnn import equiformer_v2 as E2
from repro.models.gnn import ring as JR
from repro.models.gnn.graph import from_numpy as jax_from_numpy
from repro_torch.launch.mesh import (NamedSharding, PartitionSpec, Placed,
                                     make_mesh, place)
from repro_torch.models.gnn import equiformer_v2 as T2
from repro_torch.models.gnn import ring as RG
from repro_torch.models.gnn.graph import GraphBatch, from_numpy

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


@pytest.mark.parametrize("p_data,p_model", [(2, 2), (3, 1), (2, 1), (1, 2)])
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
    assert isinstance(x, Placed) and tuple(x.sharding.spec) == ("data",)
    got = RG.unblock(x, n, p_data)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    blocks = NamedSharding(mesh, PartitionSpec("data"))
    cells = NamedSharding(mesh, PartitionSpec("data", "model"))
    with torch.no_grad():
        again = RG.forward_ring(
            model, place(torch.from_numpy(nodes), blocks),
            place(torch.from_numpy(pblk), blocks),
            place(torch.from_numpy(src_b), cells),
            place(torch.from_numpy(dst_b), cells), mesh)
    assert torch.equal(RG.unblock(again, n, p_data), got)


@pytest.mark.parametrize("p_data,p_model", [(2, 2), (2, 1)])
def test_forward_ring_makes_no_tensor_of_all_nodes(p_data, p_model):
    """No tensor an operation of ``forward_ring`` returns has the rows of
    the whole blocked layout (its inputs placed over ``data``): the
    embedding, the norms, the attention and the FFN all run block by
    block, on tensors of a block's rows.  (At p_data = 3 a block's
    degree-1 irreps reshaped for a product, n_loc + 1 rows x 3, would
    have as many rows as the whole layout.)"""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, _, model = models()
    feat, pos, snd, rcv = graph(4, n=30, e=90)
    n = feat.shape[0]
    src_b, dst_b, n_loc, _ = RG.bucket_edges(snd, rcv, n, p_data, p_model)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, n, p_data)
    n_pad = nodes.shape[0]
    assert src_b.shape[-1] < n_pad
    mesh = make_mesh((p_data, p_model), ("data", "model"),
                     ["cpu"] * (p_data * p_model))
    blocks = NamedSharding(mesh, PartitionSpec("data"))
    nodes_p = place(torch.from_numpy(nodes), blocks)
    pos_p = place(torch.from_numpy(pblk), blocks)
    rows = []

    class Rows(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and t.dim():
                    rows.append(t.shape[0])
            return out
    with torch.no_grad(), Rows():
        x = RG.forward_ring(model, nodes_p, pos_p, src_b, dst_b, mesh)
    assert n_loc + 1 in rows and n_pad not in rows
    assert x.shape[0] == n_pad


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_ring_bundle_lays_ogb_products_out_on_meta(grid):
    from repro_torch import sharding as SH
    from repro_torch.configs import get
    from repro_torch.launch import steps as S
    p_data, p_model = grid
    bundle = S.make_bundle("equiformer-v2", "ogb_products", variant="ring")
    spec = get("equiformer-v2")
    _, _, n_loc = RG.bucket_specs(2449029, 61859140, p_data, p_model)
    mesh = make_mesh(grid, ("data", "model"), ["meta"] * (p_data * p_model))
    mine = S.equiformer_ring_bundle(spec, spec.shapes["ogb_products"],
                                    p_data, p_model)
    _, _, batch = mine.place_args(mine.abstract_args, mesh, SH.TP_ONLY)
    nodes, pos, src_b, dst_b, labels = batch
    assert bundle.arg_specs[2] == mine.arg_specs[2]
    for x in batch:
        assert all(t.device.type == "meta" for t in x.shards.values())
    assert tuple(nodes.sharding.spec) == ("data", None)
    assert tuple(src_b.sharding.spec) == ("data", "model", None, None)
    assert nodes.shard(0).shape == (n_loc + 1, 100)
    cap = src_b.shape[-1]
    assert src_b.shard(0).shape == (1, 1, p_data, cap)
    assert sum(t.numel() for t in nodes.shards.values()) == \
        p_data * (n_loc + 1) * 100


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


@pytest.mark.parametrize("p_data,p_model", [(2, 2), (3, 1)])
def test_forward_ring_in_float64_matches_the_local_float64_forward(
        p_data, p_model):
    _, _, model = models()
    wide = T2.EquiformerV2(T2.EquiformerV2Config(**KW, dtype=torch.float64),
                           device="cpu")
    wide.load_state_dict(model.state_dict())
    feat, pos, snd, rcv = graph(3)
    n = feat.shape[0]
    batch = from_numpy(feat.astype(np.float64), snd, rcv,
                       pos=pos.astype(np.float64), device="cpu")
    assert isinstance(batch, GraphBatch) and batch.nodes.dtype == \
        torch.float64
    src_b, dst_b, _, _ = RG.bucket_edges(snd, rcv, n, p_data, p_model)
    nodes, pblk, _ = RG.blocked_layout(feat.astype(np.float64),
                                       pos.astype(np.float64), n, p_data)
    mesh = make_mesh((p_data, p_model), ("data", "model"),
                     ["cpu"] * (p_data * p_model))
    with torch.no_grad():
        x = RG.forward_ring(wide, torch.from_numpy(nodes),
                            torch.from_numpy(pblk), src_b, dst_b, mesh)
        _, want = wide(batch)
    got = RG.unblock(x, n, p_data)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want[:n], rtol=1e-7, atol=1e-7)
