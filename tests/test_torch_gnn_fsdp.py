"""The GNN train cells' edge-sharded step under FSDP_TP on the CPU: the
cells' ``get_fn(mesh, FSDP_TP)`` on arguments laid out by
``StepBundle.place_args`` -- the edges over ``("data", "model")``, the
nodes and parameters replicated, the sampled and molecule cells' labels
over ``data`` (the reference's ``sharding.py:41-42``,
``launch/steps.py:225-229``) -- against the port's one-device step and
the reference's jitted step.

* All 16 GNN train cells (EGNN, PNA, NequIP, Equiformer-v2 at
  full_graph_sm, minibatch_lg, ogb_products and molecule) at SMOKE in
  float32 over CPU meshes ("data", "model") of (1, 1), (1, 2), (2, 1)
  and (2, 2) (the molecule cells (1, 1) and (1, 2): their 30 edges do
  not split over four entries), from the port's seeded host arguments:
  the loss, the grad norm, every updated parameter and every moment
  equal ``get_fn()``'s bit for bit at (1, 1), within 1e-5 relative L2 a
  leaf elsewhere; two calls give the same bits, and every output leaf
  is placed by the sharding ``resolve_tree`` gives its spec.
* Two cells are held in float64 off (1, 1) (both packages' bundle
  builders on the SMOKE config in float64, as
  ``tests/test_torch_launch_gnn.py`` holds PNA at molecule): PNA and
  Equiformer-v2 at minibatch_lg.  Float32 does not resolve 1e-5 there:
  the one-device step itself moves a leaf by more than half of it when
  only the order of its edge slots changes (PNA's std of repeated
  messages, ``sqrt(clamp(E[x^2] - E[x]^2, 0) + 1e-9)``, 2.4e-3 on a
  moment; Equiformer-v2's attention bias ``alpha.b``, whose gradient
  cancels over each softmax, 9.3e-6), and the sharded step reads 4.3e-5
  and 1.004e-5 on the same leaves.  The test below keeps that
  measurement true.
* One cell a family against the reference: its host arguments through
  its jitted cell step and, carried across (``load_reference_args``),
  through the port's sharded step at (2, 2) (EGNN's molecule cell at
  (1, 2)), every updated parameter and moment within 1e-5 relative L2.
  PNA runs in float64 in both packages: in float32 the port's
  one-device step already reads 1.25e-5 against the reference on
  ``mu`` of ``layers.0.msg.weight`` (the std, above).
* PNA's max / min when a node's live messages all lie in one shard and
  are all negative (per shard, the empty shard's -inf turned into 0
  first would win the max), and Equiformer-v2's softmax when a shard
  holds only pads for a receiver: the one-device results.
* A dimension the mesh does not split evenly raises naming it.

The CPU's multithreaded float32 products and reductions do not repeat
bit for bit from call to call on Equiformer-v2's shapes (the one-device
step alone: ``embed.b``, ``so2.m0.b``); one thread does, so these tests
run on one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import steps as RS
from repro_torch import sharding as SH
from repro_torch.configs import get
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import NamedSharding, Placed, gather, make_mesh
from repro_torch.models.gnn.equiformer_v2 import (EquiformerV2,
                                                  _segment_softmax,
                                                  segment_softmax)
from repro_torch.models.gnn.graph import (EdgeShard, EdgeShards, agg_max,
                                          from_numpy)
from repro_torch.models.gnn.pna import PNA
from repro_torch.train.checkpoint import flatten
from tests.test_torch_launch_gnn import as_port_layout
from tests.test_torch_launch_lm import host, paths, rel_l2

F32_REL_L2 = 1e-5
GNN_CELLS = [(a, s) for a, s in S.all_cells() if get(a).family == "gnn"]
GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2))
#: (module doc) the cells float32 does not resolve at F32_REL_L2
ILL_CONDITIONED = (("pna", "minibatch_lg"), ("equiformer-v2", "minibatch_lg"))
#: (module doc) one cell a family against the reference, and its grid
REFERENCE_CELLS = (("egnn", "molecule", (1, 2)),
                   ("pna", "full_graph_sm", (2, 2)),
                   ("nequip", "minibatch_lg", (2, 2)),
                   ("equiformer-v2", "full_graph_sm", (2, 2)))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid_mesh(grid):
    return make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))


def whole(x):
    return gather(x) if isinstance(x, Placed) else x


def spec_of(arch, dtype):
    spec = get(arch)
    return dataclasses.replace(spec, smoke=dataclasses.replace(
        spec.smoke, dtype=dtype))


@functools.lru_cache(maxsize=None)
def case(arch, shape, dtype=torch.float32):
    """(bundle, host arguments, one-device output) of the cell at its
    SMOKE config in ``dtype``."""
    spec = spec_of(arch, dtype)
    bundle = S.gnn_bundle(spec, spec.shapes[shape], True)
    args = S.gnn_host_args(spec, spec.shapes[shape], 0, device="cpu")
    return bundle, args, bundle.get_fn()(*args)


def grid_cases():
    return [pytest.param(a, s, g, id=f"{a}-{s}-{g[0]}x{g[1]}")
            for a, s in GNN_CELLS for g in GRIDS
            if s != "molecule" or g[0] == 1 and g[1] <= 2]


def assert_placed_as_specs(bundle, got, mesh):
    """Every parameter and state leaf placed by the sharding its spec
    resolves to (replicated: each entry's shard the whole leaf)."""
    want = flatten(tuple(SH.resolve_tree(s, SH.FSDP_TP, mesh)
                         for s in bundle.arg_specs[:2]))[0]
    have = flatten(got[:2])[0]
    assert len(want) == len(have)
    for x, sh in zip(have, want):
        assert isinstance(x, Placed) and isinstance(sh, NamedSharding)
        assert x.sharding == sh
        for e in range(mesh.size):
            assert tuple(x.shard(e).shape) == x.shape


@pytest.mark.parametrize("arch,shape,grid", grid_cases())
def test_gnn_fsdp_step_matches_the_one_device_step(arch, shape, grid):
    mesh = grid_mesh(grid)
    dtype = torch.float64 if grid != (1, 1) and \
        (arch, shape) in ILL_CONDITIONED else torch.float32
    bundle, args, want = case(arch, shape, dtype)
    placed = bundle.place_args(args, mesh, SH.FSDP_TP)
    step = bundle.get_fn(mesh, SH.FSDP_TP)
    got = step(*placed)
    again = step(*placed)
    assert_placed_as_specs(bundle, got, mesh)
    W, G, A = paths(want), paths(got), paths(again)
    assert W.keys() == G.keys() == A.keys()
    for path, w in W.items():
        g = whole(G[path])
        assert torch.equal(g, whole(A[path])), path
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if grid == (1, 1) or path in ("/2/lr", "/2/skipped", "/1/step"):
            assert torch.equal(g, w), path
        else:
            assert rel_l2(g.numpy(), w.numpy()) <= F32_REL_L2, (
                path, rel_l2(g.numpy(), w.numpy()))


@pytest.mark.parametrize("arch,shape", ILL_CONDITIONED)
def test_float32_does_not_resolve_the_ill_conditioned_cells(arch, shape):
    """The one-device step alone, on the same graph with its edge slots
    in another order, moves some leaf by more than half of F32_REL_L2 in
    float32 (module doc)."""
    bundle, args, want = case(arch, shape)
    batch, labels = args[2]
    perm = torch.from_numpy(np.random.default_rng(1).permutation(
        batch.n_edge))
    moved = dataclasses.replace(batch, senders=batch.senders[perm],
                                receivers=batch.receivers[perm])
    got = paths(bundle.get_fn()(args[0], args[1], (moved, labels)))
    W = paths(want)
    assert max(rel_l2(got[p].numpy(), w.numpy()) for p, w in W.items()) \
        > F32_REL_L2 / 2


def reference_case(arch, shape, dtype):
    """The reference's bundle and host arguments, and the port's bundle,
    at the SMOKE config in ``dtype`` (the reference's float arguments
    cast)."""
    jspec, tspec = jget(arch), spec_of(arch, dtype)
    args = RS.make_host_args(arch, shape)
    if dtype == torch.float64:
        jspec = dataclasses.replace(jspec, smoke=dataclasses.replace(
            jspec.smoke, dtype=jnp.float64))
        args = jax.tree.map(lambda x: x.astype(jnp.float64)
                            if x.dtype == jnp.float32 else x, args)
    return (RS.gnn_bundle(jspec, jspec.shapes[shape], True), args,
            S.gnn_bundle(tspec, tspec.shapes[shape], True), tspec)


@pytest.mark.parametrize("arch,shape,grid", REFERENCE_CELLS,
                         ids=[a for a, _, _ in REFERENCE_CELLS])
def test_gnn_fsdp_step_matches_the_reference(arch, shape, grid,
                                             monkeypatch):
    dtype = torch.float64 if arch == "pna" else torch.float32
    ref, args, bundle, tspec = reference_case(arch, shape, dtype)
    want = jax.tree.map(np.asarray, jax.jit(ref.get_fn())(*args))
    ref_args = jax.tree.map(np.asarray, args)
    monkeypatch.setattr(S, "get_arch", lambda _: tspec)
    port_args = S.load_reference_args(arch, shape, ref_args, device="cpu")
    mesh = grid_mesh(grid)
    got = bundle.get_fn(mesh, SH.FSDP_TP)(
        *bundle.place_args(port_args, mesh, SH.FSDP_TP))
    w_params, w_state = as_port_layout(arch, shape, want, ref_args)
    W = paths((w_params, w_state.mu, w_state.nu))
    G = paths((got[0], got[1].mu, got[1].nu))
    assert W.keys() == G.keys()
    for path, w in W.items():
        assert rel_l2(host(whole(G[path])), host(w)) <= F32_REL_L2, (
            path, rel_l2(host(whole(G[path])), host(w)))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   rtol=F32_REL_L2, err_msg=k)
    assert int(whole(got[1].step)) == int(want[1].step) == 1


def two_shards(batch, split: int) -> EdgeShards:
    """The batch's edges as two shards on the CPU, cut at ``split``,
    each run with the module's own parameters."""
    cpu = torch.device("cpu")
    s, r = batch.senders, batch.receivers
    return EdgeShards([EdgeShard(cpu, s[:split], r[:split]),
                       EdgeShard(cpu, s[split:], r[split:])], cpu)


def test_pna_max_min_when_a_nodes_live_messages_lie_in_one_shard():
    """Node 0's live messages all lie in the second shard and are all
    negative in every channel (a message bias of -3): its max is theirs,
    below 0, where a max taken per shard after ``nan_to_num`` would read
    the first shard's empty 0.  Node 1's lie in the first shard; node 2
    has none (0 in both).  The sharded forward gives the one-device
    output."""
    cfg = dataclasses.replace(get("pna").smoke, n_layers=1, d_in=4)
    model = PNA(cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    with torch.no_grad():
        model.layers[0].msg.bias.fill_(-3.0)
    rng = np.random.default_rng(4)
    senders = np.array([1, 2, 3, 4, 3, 4, 5, 1], np.int32)
    receivers = np.array([1, 1, 1, 5, 0, 0, 0, 5], np.int32)
    batch = from_numpy(rng.normal(size=(6, 4)).astype(np.float32),
                       senders, receivers, e_cap=8, device="cpu")
    layer = model.layers[0]
    h = torch.nn.functional.silu(model.embed(batch.nodes))
    edges = two_shards(batch, 4)
    parts = [layer.edge_parts(sh, h, batch.n_node) for sh in edges]
    mx = edges.max([p[3] for p in parts])
    one = layer.edge_parts(EdgeShards.whole(batch).shards[0], h,
                           batch.n_node)[3]
    assert (mx[0] < 0).all() and torch.equal(mx, one)
    assert torch.isinf(parts[0][3][0]).all()        # the empty shard
    with torch.no_grad():
        torch.testing.assert_close(model(batch, edges), model(batch),
                                   rtol=1e-6, atol=1e-7)
        # the per-shard nan_to_num this order rules out reads 0 there
        per_shard = torch.maximum(*(torch.nan_to_num(p[3], neginf=0.0)
                                    for p in parts))
        assert (per_shard[0] == 0).all()


def test_equiformer_softmax_when_a_shard_holds_only_pads_for_a_receiver():
    """Receiver 2's live edges lie in the second shard; the first holds
    pad slots aimed at it (masked) and at the dump row.  The logits lie
    near -100, so a shift by the first shard's empty max turned into 0
    (not the max over the shards) would underflow every ``exp``: the
    shards' softmax weights are the one-device ``_segment_softmax``'s,
    and a shard of pads alone gives zeros; the forward over a first
    shard of pads alone gives the one-device output."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((10, 3)).astype(
        np.float32) * 4 - 100)
    seg = torch.tensor([2, 4, 4, 2, 0, 0, 2, 2, 1, 4])
    mask = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    cpu = torch.device("cpu")
    edges = EdgeShards([EdgeShard(cpu, seg[:4], seg[:4]),
                        EdgeShard(cpu, seg[4:], seg[4:])], cpu)
    got = segment_softmax([logits[:4], logits[4:]], [mask[:4], mask[4:]],
                          edges, 5)
    want = _segment_softmax(logits, seg, 5, mask)
    torch.testing.assert_close(torch.cat(got), want, rtol=1e-6, atol=1e-7)
    assert not got[0].any()
    assert torch.isneginf(agg_max(torch.where(mask[:4, None], logits[:4],
                                              -torch.inf), seg[:4], 5)).all()
    cfg = dataclasses.replace(get("equiformer-v2").smoke, n_layers=1)
    model = EquiformerV2(cfg, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    n, e = 7, 12
    batch = from_numpy(rng.normal(size=(n, cfg.d_in)).astype(np.float32),
                       rng.integers(0, n, e // 2).astype(np.int32),
                       rng.integers(0, n, e // 2).astype(np.int32),
                       pos=rng.normal(size=(n, 3)).astype(np.float32),
                       e_cap=e, device="cpu")
    moved = dataclasses.replace(batch, senders=batch.senders.roll(e // 2),
                                receivers=batch.receivers.roll(e // 2))
    with torch.no_grad():
        torch.testing.assert_close(model(moved, two_shards(moved, e // 2))[1],
                                   model(batch)[1], rtol=1e-5, atol=1e-6)


def test_an_uneven_split_raises_naming_the_dimension():
    """SMOKE's molecule cells: 30 edge slots over four entries, and 3
    molecules' targets over two data rows."""
    bundle, args, _ = case("egnn", "molecule")
    with pytest.raises(ValueError, match=r"senders: dimension 0 \(edges\)"):
        bundle.place_args(args, grid_mesh((2, 2)), SH.FSDP_TP)
    with pytest.raises(ValueError, match=r"dimension 0 \(batch\) of size 3"):
        bundle.place_args(args, grid_mesh((2, 1)), SH.FSDP_TP)
