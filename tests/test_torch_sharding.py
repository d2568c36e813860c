"""The port's sharding rules (``repro_torch.sharding``) and tensor
layouts (``repro_torch.launch.mesh``) against the reference's
(``repro.sharding``) on the CPU:

* ``resolve_tree`` gives the reference's ``PartitionSpec`` for every
  leaf of every LM configuration's ``param_specs``, ``cache_specs`` and
  ``state_specs`` (with and without ``compress``), and of DIEN's, under
  ``FSDP_TP``, ``TP_ONLY`` and their ``drop_pod`` forms, on ``(16, 16)``
  ``("data", "model")``, ``(2, 16, 16)`` with ``"pod"`` and ``(1, 1)``
  (the reference's side on ``jax.sharding.AbstractMesh``, whose
  ``resolve`` reads only the axis names); the logical trees themselves
  equal the reference's;
* ``resolve``'s rules: an unknown name replicates, a composite rule
  drops the axes the mesh lacks and collapses to one name;
* ``place`` / ``gather`` round trips bit for bit, with shards of
  ``ceil(n / p)`` rows where ``p`` does not divide ``n``, one shard per
  distinct (block, device) pair, each its own contiguous tensor;
* ``constraint`` and ``shard_act`` return their input outside the
  context and where the spec names no mesh axis, and lay it out by the
  spec where it names one;
* the reference's GNN ``param_specs`` fault: its tree does not match its
  parameters at 2 layers (EGNN 30 leaves against 18), while the port's
  matches its own module's parameter tree and replicates it.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as JS
from repro.launch import steps as RS
from repro.models import dien as jdien
from repro.models import transformer as jtf
from repro.train import optimizer as JO
from repro_torch import sharding as SH
from repro_torch.configs import get
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (NamedSharding, PartitionSpec, Placed,
                                     gather, make_mesh, place, place_zeros)
from repro_torch.models import dien as D
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import flatten

LM_CONFIGS = ("qwen2_1_5b", "qwen2_7b", "phi3_medium_14b",
              "deepseek_v2_lite_16b", "deepseek_v2_236b")
RULES = {"fsdp_tp": (JS.FSDP_TP, SH.FSDP_TP),
         "tp_only": (JS.TP_ONLY, SH.TP_ONLY),
         "fsdp_tp_single_pod": (JS.drop_pod(JS.FSDP_TP),
                                SH.drop_pod(SH.FSDP_TP)),
         "tp_only_single_pod": (JS.drop_pod(JS.TP_ONLY),
                                SH.drop_pod(SH.TP_ONLY))}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def meshes(name):
    shape, names = MESHES[name]
    return (AbstractMesh(shape, names),
            make_mesh(shape, names, ["cpu"] * int(np.prod(shape))))


def ref_leaves(tree):
    return [tuple(x.spec) for x in jax.tree.leaves(tree)]


def port_leaves(tree):
    leaves = flatten(tree)[0]
    assert all(isinstance(x, NamedSharding) for x in leaves)
    return [tuple(x.spec) for x in leaves]


def spec_leaves(tree, is_leaf):
    return jax.tree.leaves(tree, is_leaf=is_leaf)


def is_ref_spec(x):
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def lm_pair(name):
    jmod = importlib.import_module(f"repro.configs.{name}")
    tmod = importlib.import_module(f"repro_torch.configs.{name}")
    return jmod.CONFIG, tmod.CONFIG


def spec_trees(kind, name):
    """(reference's logical tree, port's) of one kind."""
    if name == "dien":
        jcfg = importlib.import_module("repro.configs.dien").CONFIG
        tcfg = importlib.import_module("repro_torch.configs.dien").CONFIG
        jp, tp = jdien.param_specs(jcfg), D.param_specs(tcfg)
    else:
        jcfg, tcfg = lm_pair(name)
        if kind == "cache":
            return jtf.cache_specs(jcfg), tf.cache_specs(tcfg)
        jp, tp = jtf.param_specs(jcfg), tf.param_specs(tcfg)
    if kind == "params":
        return jp, tp
    compress = kind == "state_compress"
    return JO.state_specs(jp, compress), O.state_specs(tp, compress)


KINDS = ("params", "cache", "state", "state_compress")


class Box:
    """A spec as one leaf of ``flatten`` (which walks into tuples)."""

    def __init__(self, spec):
        self.spec = spec


@pytest.mark.parametrize("name,kind", [
    (name, kind) for name in LM_CONFIGS + ("dien",) for kind in KINDS
    if not (name == "dien" and kind == "cache")])
def test_logical_spec_trees_equal_the_references(name, kind):
    jt, tt = spec_trees(kind, name)
    want = spec_leaves(jt, is_ref_spec)
    got = [b.spec for b in flatten(SH.map_specs(Box, tt))[0]]
    assert got == want


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", LM_CONFIGS + ("dien",))
def test_resolve_tree_gives_the_references_partition_specs(name, rules,
                                                           mesh_name):
    jmesh, tmesh = meshes(mesh_name)
    jrules, trules = RULES[rules]
    for kind in KINDS:
        if name == "dien" and kind == "cache":
            continue
        jt, tt = spec_trees(kind, name)
        want = ref_leaves(JS.resolve_tree(jt, jrules, jmesh))
        got = port_leaves(SH.resolve_tree(tt, trules, tmesh))
        assert got == want, (kind, got, want)


def test_resolve_keeps_the_references_rules():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    rules = dict(SH.FSDP_TP, odd=("pod", "data", "model"),
                 lone=("pod", "model"), gone="pod")
    jrules = dict(JS.FSDP_TP, odd=("pod", "data", "model"),
                  lone=("pod", "model"), gone="pod")
    for spec in [("unknown", None), ("odd", None), ("lone", "gone"),
                 None, (), ("cache_seq",), ("edges",)]:
        got = SH.resolve(spec, rules, mesh)
        want = JS.resolve(spec, jrules, jmesh)
        assert tuple(got.spec) == tuple(want.spec), spec
    assert SH.resolve(("batch", "lone"), rules, mesh).spec == \
        PartitionSpec("data", "model")
    assert SH.resolve(("unknown",), rules, mesh).spec == PartitionSpec(None)


def test_named_sharding_is_hashable_and_checks_its_axes():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    a = NamedSharding(mesh, PartitionSpec("data", None))
    b = NamedSharding(make_mesh((2, 2), ("data", "model"), ["cpu"] * 4),
                      PartitionSpec("data", None))
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != NamedSharding(mesh, PartitionSpec("model", None))
    assert PartitionSpec() != PartitionSpec(None)
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(mesh, PartitionSpec("pod"))
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(mesh, PartitionSpec("model", "model"))


PLACEMENTS = [
    ((4,), ("model",), (10, 3), PartitionSpec("model")),
    ((4,), ("model",), (3, 5), PartitionSpec(None, "model")),
    ((3,), ("model",), (7,), PartitionSpec("model")),
    ((2, 2), ("data", "model"), (5, 7), PartitionSpec("data", "model")),
    ((2, 2), ("data", "model"), (9, 2), PartitionSpec(("data", "model"))),
    ((2, 2), ("data", "model"), (6, 4), PartitionSpec(None, "model")),
    ((2, 3), ("data", "model"), (2, 4, 5), PartitionSpec("model", None,
                                                         "data")),
    ((2, 2), ("data", "model"), (3, 3), PartitionSpec()),
    ((2, 2), ("data", "model"), (), PartitionSpec()),
]


@pytest.mark.parametrize("shape,axes,tshape,spec", PLACEMENTS)
def test_place_and_gather_round_trip(shape, axes, tshape, spec):
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    x = torch.arange(int(np.prod(tshape)), dtype=torch.float32).reshape(
        tshape)
    sh = NamedSharding(mesh, spec)
    placed = place(x, sh)
    assert isinstance(placed, Placed) and placed.shape == tuple(tshape)
    assert torch.equal(gather(placed), x)
    parts = sh.parts(len(tshape))
    assert len(placed.shards) == int(np.prod(parts))   # one device: a block
    for (block, dev), shard in placed.shards.items():
        bounds = placed.bounds(block)
        assert shard.is_contiguous() and shard.device == dev
        assert tuple(shard.shape) == tuple(hi - lo for lo, hi in bounds)
        for (lo, hi), n, p, i in zip(bounds, tshape, parts, block):
            step = -(-n // p)
            assert (lo, hi) == (min(i * step, n), min((i + 1) * step, n))
        assert torch.equal(shard, x[tuple(slice(lo, hi)
                                          for lo, hi in bounds)])
        assert shard.data_ptr() != x.data_ptr() or shard.numel() == 0
    zeros = place_zeros(tshape, torch.float32, sh)
    assert torch.equal(gather(zeros), torch.zeros(tshape))
    assert sum(placed.nbytes_by_device().values()) == x.numel() * 4


def test_place_copies_once_per_distinct_device():
    """Entries that hold the same block on one device share one shard;
    ``blocks`` lists each block once, in mesh order."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.randn(6, 4)
    placed = place(x, NamedSharding(mesh, PartitionSpec(None, "model")))
    assert len(placed.shards) == 2 and len(placed.blocks) == 2
    assert placed.shard(0) is placed.shard(2)       # (0, 0) and (1, 0)
    assert placed.shard(1) is placed.shard(3)
    assert [b[0][0] for b in placed.blocks] == [(0, 0), (0, 1)]
    rep = place(x, NamedSharding(mesh, PartitionSpec()))
    assert len(rep.shards) == 1


def test_constraint_and_shard_act_return_their_input():
    """Outside the context, and where a spec names no axis of the mesh,
    ``shard_act`` and ``constraint`` return their input; where it names
    one they lay it out by it (the values unchanged), and a tensor
    already so laid out is returned as it is."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.randn(4, 3)
    assert SH.shard_act(x, ("batch", "act_seq")) is x
    with SH.activation_sharding(SH.FSDP_TP, mesh):
        assert SH.shard_act(x, ("seq", None)) is x
        placed = SH.shard_act(x, ("batch", "act_seq"))
        assert SH.shard_act(placed, ("batch", "act_seq")) is placed
        again = SH.shard_act(placed, ("batch", None))
    assert isinstance(placed, Placed) and tuple(placed.sharding.spec) == \
        ("data", "model") and len(placed.shards) == 4
    assert torch.equal(gather(placed), x) and torch.equal(gather(again), x)
    assert tuple(again.sharding.spec) == ("data", None)
    assert SH.constraint(x, ("seq", "kv_heads"), SH.FSDP_TP, mesh) is x
    assert torch.equal(gather(SH.constraint(x, ("batch", None), SH.FSDP_TP,
                                            mesh)), x)
    fn = SH.wrap_with_activation_sharding(
        lambda y: SH.shard_act(y, ("seq", None)) * 2, SH.FSDP_TP, mesh)
    assert torch.equal(fn(x), x * 2)
    assert not SH._ACT_CTX and SH.active_rules() is None


def test_act_spec_matches_the_reference():
    for name in LM_CONFIGS:
        jcfg, tcfg = lm_pair(name)
        for t in (1, 16, 17, 4096):
            for sp in (True, False):
                got = tf.act_spec(dataclasses.replace(tcfg, seq_parallel=sp),
                                  t)
                want = jtf.act_spec(dataclasses.replace(jcfg,
                                                        seq_parallel=sp), t)
                assert got == want


GNNS = [("egnn", "EGNN", 30, 18), ("nequip", "NequIP", 20, 13),
        ("equiformer_v2", "EquiformerV2", 42, 23), ("pna", "PNA", 12, 8)]


@pytest.mark.parametrize("mod,cls,n_params,n_ref_specs", GNNS)
def test_gnn_param_specs_match_the_ports_own_tree(mod, cls, n_params,
                                                  n_ref_specs):
    """The reference's GNN ``param_specs`` build their tree from a
    one-layer tiny config: at the SMOKE config (2 layers) it does not
    match the reference's own parameters.  The port's match its module's
    parameter tree, every leaf replicated."""
    jm = importlib.import_module(f"repro.models.gnn.{mod}")
    tm = importlib.import_module(f"repro_torch.models.gnn.{mod}")
    jcfg = importlib.import_module(f"repro.configs.{mod}").SMOKE
    tcfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    assert jcfg.n_layers == 2
    ref_params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    ref_specs = jax.tree.leaves(jm.param_specs(jcfg), is_leaf=is_ref_spec)
    assert len(jax.tree.leaves(ref_params)) == n_params
    assert len(ref_specs) == n_ref_specs != n_params
    specs = tm.param_specs(tcfg)
    model = getattr(tm, cls)(tcfg, device="cpu")
    assert list(specs) == [k for k, _ in model.named_parameters()]
    assert len(specs) == n_params
    assert set(specs.values()) == {()}
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert {s.spec for s in SH.resolve_tree(specs, SH.FSDP_TP,
                                            mesh).values()} == \
        {PartitionSpec()}


GNN_CELLS = [(a, s) for a, s in S.all_cells() if get(a).family == "gnn"]


def port_spec_leaves(tree) -> list:
    """The specs of a resolved tree in the reference's leaf order: a
    dataclass's fields in order, its ``int`` fields left out."""
    if isinstance(tree, NamedSharding):
        return [tuple(tree.spec)]
    if dataclasses.is_dataclass(tree):
        return [s for f in dataclasses.fields(tree)
                if not isinstance(getattr(tree, f.name), int)
                for s in port_spec_leaves(getattr(tree, f.name))]
    return [s for x in tree for s in port_spec_leaves(x)]


@pytest.mark.parametrize("arch,shape", GNN_CELLS,
                         ids=[f"{a}-{s}" for a, s in GNN_CELLS])
def test_gnn_cells_are_placed_and_their_placed_step_runs(arch, shape):
    """The port's ``resolve_tree`` took no dataclass (``TypeError: not a
    spec tree: GraphBatch(...)``), so ``place_args`` failed on every GNN
    train cell.  Now the batch's specs resolve to the reference's leaf by
    leaf on (2, 2) -- the edges over ("data", "model"), the int fields
    kept -- every parameter and moment replicated in both; ``place_args``
    lays the batch out (the molecule cells on (1, 2): their SMOKE 30
    edges and 3 molecules do not split over (2, 2), which raises naming
    the edges), and the edge-sharded step on it runs without gathering
    the batch: its loss within 1e-5 of the one-device step's
    (``tests/test_torch_gnn_fsdp.py`` holds the rest of its output)."""
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    tmesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ref = RS.make_bundle(arch, shape, smoke=True)
    port = S.make_bundle(arch, shape, smoke=True)
    want = ref_leaves(JS.resolve_tree(ref.arg_specs[2], JS.FSDP_TP, jmesh))
    got = port_spec_leaves(SH.resolve_tree(port.arg_specs[2], SH.FSDP_TP,
                                           tmesh))
    assert got == want
    assert (("data", "model"),) in got
    for i in (0, 1):
        assert set(ref_leaves(JS.resolve_tree(ref.arg_specs[i], JS.FSDP_TP,
                                              jmesh))) == {()}
        assert set(port_leaves(SH.resolve_tree(port.arg_specs[i],
                                               SH.FSDP_TP, tmesh))) == {()}
    args = S.make_host_args(arch, shape, device="cpu")
    mesh = tmesh
    if shape == "molecule":
        with pytest.raises(ValueError, match=r"senders.*\(edges\)"):
            port.place_args(args, mesh, SH.FSDP_TP)
        mesh = make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    placed = port.place_args(args, mesh, SH.FSDP_TP)
    batch = placed[2][0]
    assert isinstance(batch.senders, Placed) and \
        batch.senders.sharding.spec == PartitionSpec(("data", "model"))
    assert (batch.n_node, batch.n_graph) == (args[2][0].n_node,
                                             args[2][0].n_graph)
    assert torch.equal(gather(batch.receivers), args[2][0].receivers)
    got = port.get_fn(mesh, SH.FSDP_TP)(*placed)
    want = port.get_fn()(*args)
    torch.testing.assert_close(got[2]["loss"], want[2]["loss"], rtol=1e-5,
                               atol=0)
