"""The dry run, its collective accounting and the roofline report
(``repro_torch.launch.{dryrun,collectives,roofline}``) against the
reference's, on the CPU and the meta device:

* every cell's fitted shard shape of every argument leaf on the
  ``pod16x16`` mesh, and of one cell a family on ``pod2x16x16``, equals
  the reference's (``_fit_shardings`` and ``NamedSharding.shard_shape``
  on an ``AbstractMesh``, in one subprocess: ``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` when imported); leaves paired by path, the GNNs'
  parameters apart (their trees differ: modules by name against nested
  dicts); the dtypes equal but for the GraphBatch's int64 indexes;
* a one-entry meta dry run of a SMOKE cell counts the FLOPs of
  ``FlopCounterMode`` over the same step on the CPU on ``make_host_args``
  and the same bytes by op as the count there; flash_decode's ``cost``
  equals ``FlopCounterMode`` over its plain version at the full window;
* the bytes the collectives move over four ``"cpu"`` entries equal
  hand-computed numbers, and ``ring_wire_bytes`` the reference's
  ``hlo.collective_stats`` of a one-line HLO of the same op and group;
* ``prefill`` and two ``decode_step``s on an ``FSDP_TP``-placed tree
  over a (2, 2) CPU mesh give the ``TP_ONLY`` tree's bits (qwen2-1.5b and
  deepseek-v2-lite SMOKE), within 1e-4 of the one-device path;
* a (2, 2) meta dry run of a SMOKE cell of each family and of the ring
  variant reaches ``ok`` without looking for CUDA, dspc ``build``
  reaches ``host_sync``; the FLOPs summed over the entries equal the
  one-entry count (an LM and a GNN cell: the heads, FFN slices and edge
  shards split the work, the controller's runs once either way);
* the port's roofline table equals the reference's over the port's
  records, in markdown and csv;
* outside a dry run the counters change no output and no launch count.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo as ref_hlo
from repro.launch import roofline as ref_roofline
from repro_torch import sharding as SH
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (NamedSharding, PartitionSpec,
                                     map_tree, counting, gather_entry,
                                     make_mesh, place, place_tree, psum,
                                     all_gather, reduce_scatter, working)
from repro_torch.kernels.flash_decode import kernel as FD
from repro_torch.kernels.flash_decode.ops import decode_attention
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.models import transformer as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI_POD_CELLS = (("qwen2-1.5b", "train_4k"), ("egnn", "full_graph_sm"),
                   ("dien", "serve_p99"), ("dspc", "query_batch"))
#: The reference's shard shapes, in one subprocess (module doc).
REFERENCE = r"""
import json, sys
import jax
from jax.sharding import AbstractMesh, NamedSharding
from repro.launch.dryrun import _fit_shardings
from repro.launch.steps import all_cells, make_bundle
from repro.sharding import FSDP_TP, drop_pod, resolve_tree
multi_cells = [tuple(c) for c in json.loads(sys.argv[1])]

def key(p):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in p)

out = {}
for multi, cells in ((False, all_cells()), (True, multi_cells)):
    shape = (2, 16, 16) if multi else (16, 16)
    mesh = AbstractMesh(shape, ("pod", "data", "model")[-len(shape):])
    rules = FSDP_TP if multi else drop_pod(FSDP_TP)
    for a, s in cells:
        b = make_bundle(a, s, smoke=False)
        sh = _fit_shardings(tuple(resolve_tree(sp, rules, mesh)
                                  for sp in b.arg_specs), b.abstract_args)
        got = {key(p): x for p, x in jax.tree_util.tree_flatten_with_path(
            sh, is_leaf=lambda x: isinstance(x, NamedSharding))[0]}
        out[f"{multi}/{a}/{s}"] = {
            key(p): [list(got[key(p)].shard_shape(x.shape)), str(x.dtype)]
            for p, x in jax.tree_util.tree_flatten_with_path(
                b.abstract_args)[0] if key(p) in got}
print(json.dumps(out))
"""


class _Reference:
    """The reference's shard shapes from a subprocess started when the
    module's first test starts, read when the shape tests (last in the
    file) need them: the other tests run meanwhile."""

    def __init__(self) -> None:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, json.dumps(MULTI_POD_CELLS)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.shards = None

    def result(self) -> dict:
        if self.shards is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-3000:]
            self.shards = json.loads(out)
        return self.shards

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference_shards():
    ref = _Reference()
    yield ref
    ref.close()


def named(tree):
    """``tree`` with each named tuple (``OptState``) a dict by field, as
    the reference's paths name them."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: named(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: named(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(named(v) for v in tree)
    return tree


def port_shards(arch, shape, multi_pod):
    """{path: (shard shape, dtype)} of the port's fitted shardings."""
    bundle = S.make_bundle(arch, shape)
    mesh = D.meta_mesh(multi_pod)
    rules = SH.FSDP_TP if multi_pod else SH.drop_pod(SH.FSDP_TP)
    out = {}
    for i, (a, sp) in enumerate(zip(bundle.abstract_args, bundle.arg_specs)):
        fitted = named(D.fit_shardings(SH.resolve_tree(sp, rules, mesh), a))
        a = named(a)

        def one(path, x, sh, i=i):
            shape = [n // p for n, p in zip(x.shape, sh.parts(len(x.shape)))]
            out[f"{i}.{path}".rstrip(".")] = (shape, str(x.dtype).replace(
                "torch.", ""))
        map_tree(one, a, fitted)
    return out


# -------------------------------------------------------------------------
# Counting on one entry: meta against the CPU
# -------------------------------------------------------------------------
ONE_ENTRY_CELLS = (("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "decode_32k"),
                   ("deepseek-v2-lite-16b", "decode_32k"),
                   ("dien", "train_batch"), ("egnn", "full_graph_sm"))


def cpu_count(arch, shape):
    """(FlopCounterMode's FLOPs, the port's tally) of the cell's SMOKE step
    on ``make_host_args`` on a (1, 1) CPU mesh, placed as the dry run
    places its meta arguments."""
    bundle = S.make_bundle(arch, shape, smoke=True)
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    rules = SH.drop_pod(SH.FSDP_TP)

    def args():
        host = S.make_host_args(arch, shape, device="cpu")
        return tuple(place_tree(a, D.fit_shardings(
            SH.resolve_tree(sp, rules, mesh), a))
            for a, sp in zip(host, bundle.arg_specs))
    fn = bundle.get_fn(mesh, rules)
    with FlopCounterMode(display=False) as fc:
        fn(*args())
    _, tally, _ = D.count_step(fn, args(), 1, "cpu")
    return fc.get_total_flops(), tally


@pytest.mark.parametrize("arch,shape", ONE_ENTRY_CELLS)
def test_one_entry_meta_count_equals_the_cpu_count(tmp_path, arch, shape):
    rec = D.run_cell(arch, shape, multi_pod=False, mesh_shape=(1, 1),
                     smoke=True, out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    flops, tally = cpu_count(arch, shape)
    assert rec["flops_per_device"] == flops == float(tally.flops[0])
    assert rec["bytes_by_op"] == pytest.approx(dict(tally.bytes_by_op),
                                               rel=0, abs=0)
    assert rec["bytes_per_device"] == float(tally.bytes[0])


def test_flash_decode_cost_equals_flop_counter_over_the_plain_version():
    b, h, kvh, s, d = 2, 6, 2, 48, 16
    q = torch.randn(b, h, d)
    k, v = torch.randn(b, s, kvh, d), torch.randn(b, s, kvh, d)
    lengths = torch.full((b,), s, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        decode_attention_ref(q, k, v, lengths)
    flops, nbytes = FD.cost(b, h, kvh, s, d, torch.float32)
    assert flops == fc.get_total_flops() == 4 * b * h * s * d
    assert nbytes == 2 * b * s * kvh * d * 4 + 2 * b * h * d * 4 + 4 * b


# -------------------------------------------------------------------------
# The collectives' moves over four CPU entries
# -------------------------------------------------------------------------
def test_collectives_move_the_bytes_reckoned_by_hand():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.randn(8, 6)
    nb = x.numel() * 4
    with C.counted(4, "cpu") as t:
        parts = []
        for e in range(4):
            with working(e):
                parts.append(x * 1.0)
        psum(parts, "cpu")
        all_gather(parts, 1, "cpu")
    # three parts into entry 0, each way
    assert t.moved["psum"][0].tolist() == [3 * nb, 0, 0, 0]
    assert t.moved["psum"][1].tolist() == [0, nb, nb, nb]
    assert t.moved["all_gather"][0].tolist() == [3 * nb, 0, 0, 0]
    # a [8, 6] leaf split over data on rows: each entry gathers the other
    # data row's block (4 x 6 floats) from the entry of its model column
    leaf = place(x, NamedSharding(mesh, PartitionSpec("data")))
    blk = 4 * 6 * 4
    with C.counted(4, "cpu") as t:
        for e in range(4):
            gather_entry(leaf, e)
        reduce_scatter(leaf, {e: x.clone() for e in range(4)})
    assert t.moved["gather_entry"][0].tolist() == [blk] * 4
    assert t.moved["gather_entry"][1].tolist() == [blk] * 4
    # each block from the three other views that hold it
    assert t.moved["reduce_scatter"][0].tolist() == [3 * blk] * 4
    stats = C.collective_stats(t)
    assert stats.wire_bytes == 4 * blk
    assert stats.counts == {"gather_entry": 4, "reduce_scatter": 1}


@pytest.mark.parametrize("op,hlo_op", [
    ("psum", "all-reduce"), ("all_gather", "all-gather"),
    ("gather_entry", "all-gather"), ("reduce_scatter", "reduce-scatter"),
    ("ring", "collective-permute"), ("place", "all-to-all")])
def test_ring_estimate_equals_the_reference(op, hlo_op):
    k, result = 4, 8 * 6 * 4
    line = (f"  %x = f32[8,6]{{1,0}} {hlo_op}(f32[8,6]{{1,0}} %p), "
            f"replica_groups={{{{0,1,2,3}}}}")
    want = ref_hlo.collective_stats(line, 16)
    assert C.ring_wire_bytes(op, result, k) == want.wire_bytes
    assert want.counts == {hlo_op: 1}


# -------------------------------------------------------------------------
# Serving an FSDP_TP-placed tree
# -------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b"])
def test_serving_an_fsdp_tree_gives_the_tp_only_bits(arch):
    cfg = S.get_arch(arch).smoke
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    params = map_tree(lambda _, x: x.float(), params)
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    runs = {}
    for name, tree in (("fsdp", tf.place_params(params, cfg, mesh,
                                                rules=SH.FSDP_TP)),
                       ("tp", tf.place_params(params, cfg, mesh)),
                       ("one", params)):
        logits, cache = tf.prefill(tree, toks, cfg, 16, mesh=mesh if
                                   name == "one" else None)
        out = [logits]
        tok = toks[:, -1]
        for _ in range(2):
            logits, cache = tf.decode_step(tree, cache, tok, cfg)
            out.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        runs[name] = out
    for got, want, one in zip(runs["fsdp"], runs["tp"], runs["one"]):
        assert torch.equal(got, want)
        torch.testing.assert_close(got, one, rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------------------
# Dry runs on meta
# -------------------------------------------------------------------------
def _no_cuda(*_, **__):
    raise AssertionError("the dry run looked for CUDA")


@pytest.mark.parametrize("arch,shape,variant", [
    ("qwen2-1.5b", "decode_32k", ""), ("deepseek-v2-lite-16b", "train_4k", ""),
    ("egnn", "molecule", ""), ("dien", "serve_p99", ""),
    ("dspc", "query_batch", ""), ("equiformer-v2", "full_graph_sm", "ring"),
    ("dspc", "build", "")])
def test_dry_run_on_meta(tmp_path, monkeypatch, arch, shape, variant):
    monkeypatch.setattr(torch.cuda, "is_available", _no_cuda)
    monkeypatch.setattr(torch.cuda, "device_count", _no_cuda)
    rec = D.run_cell(arch, shape, multi_pod=False, mesh_shape=(2, 2),
                     smoke=not variant, variant=variant,
                     out_dir=str(tmp_path))
    if shape == "build":
        assert rec["status"] == "host_sync", rec.get("error")
        assert "frontier" in rec["host_read"]
        assert rec["memory"]["argument_size_in_bytes"] > 0
        return
    assert rec["status"] == "ok", rec.get("error")
    for k in ("chips", "model_flops", "notes", "flops_per_device",
              "bytes_per_device", "collective_wire_bytes_per_device",
              "collective_counts", "collective_by_op_bytes",
              "ring_estimate_by_op_bytes", "ops", "compute_term_s",
              "memory_term_s", "collective_term_s", "dominant_term",
              "model_flops_per_device", "useful_flops_ratio", "fits",
              "dry_s"):
        assert k in rec, k
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["bytes_per_device"] > 0
    # the DSPC merge core is elementwise: no FLOPs by FlopCounterMode's
    assert (rec["flops_per_device"] > 0) == (arch != "dspc")
    # reused, not run again
    assert D.run_cell(arch, shape, multi_pod=False, mesh_shape=(2, 2),
                      smoke=not variant, variant=variant,
                      out_dir=str(tmp_path))["dry_s"] == rec["dry_s"]


@pytest.mark.parametrize("arch,shape", [("deepseek-v2-lite-16b", "train_4k"),
                                        ("egnn", "full_graph_sm")])
def test_alike_entries_count_as_every_entry_run(tmp_path, arch, shape):
    """A (2, 2) meta dry run, alike entries run once, counts each entry's
    FLOPs as the same step run entry by entry on four CPU entries, and
    (module doc of ``launch.dryrun``) beside the one-entry count: the
    GNN's edge shards and node update split it exactly; the LM's sum is
    larger (each model entry projects the replicated K and V heads, the
    MoE's shared experts, and its row's router input)."""
    one, four = (D.run_cell(arch, shape, multi_pod=False, mesh_shape=m,
                            smoke=True, out_dir=str(tmp_path))
                 for m in ((1, 1), (2, 2)))
    bundle = S.make_bundle(arch, shape, smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    rules = SH.drop_pod(SH.FSDP_TP)
    args = tuple(place_tree(a, D.fit_shardings(SH.resolve_tree(sp, rules,
                                                               mesh), a))
                 for a, sp in zip(S.make_host_args(arch, shape,
                                                   device="cpu"),
                                  bundle.arg_specs))
    _, tally, _ = D.count_step(bundle.get_fn(mesh, rules), args, 4, "cpu")
    assert four["flops_sum"] == float(tally.flops.sum())
    assert four["flops_per_device"] == float(tally.flops.max())
    assert four["collective_wire_bytes_per_device"] == \
        C.collective_stats(tally).wire_bytes
    if arch == "egnn":
        assert four["flops_sum"] == one["flops_per_device"]
    else:
        assert four["flops_sum"] > one["flops_per_device"]


def test_roofline_tables_equal_the_reference(tmp_path):
    rows = [D.run_cell(a, s, multi_pod=False, mesh_shape=(2, 2), smoke=True,
                       out_dir=str(tmp_path))
            for a, s in (("egnn", "molecule"), ("dien", "serve_p99"))]
    rows.append({"arch": "x", "shape": "y", "status": "error"})
    for md in (True, False):
        assert R.table(rows, md=md) == ref_roofline.table(rows, md=md)
    sync = D.run_cell("dspc", "inc_update", multi_pod=False,
                      mesh_shape=(2, 2), smoke=True, out_dir=str(tmp_path))
    assert sync["status"] == "host_sync"
    assert R.table([sync]).endswith("| host_sync |")
    assert [r["shape"] for r in R.load("mesh2x2__smoke", str(tmp_path))] \
        == ["serve_p99", "inc_update", "molecule"]


def test_counters_off_change_nothing():
    q, k, v = torch.randn(2, 4, 16), torch.randn(2, 8, 2, 16), \
        torch.randn(2, 8, 2, 16)
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    before = FD.launches.count
    plain = decode_attention(q, k, v, lengths)
    with counting(1) as t:
        counted = decode_attention(q, k, v, lengths)
    assert torch.equal(plain, counted)
    assert FD.launches.count == before
    assert t.ops == {"flash_decode": 1}
    assert torch.equal(plain, decode_attention_ref(q, k, v, lengths))


#: The GraphBatch's index leaves: int64 in the port, int32 in the
#: reference.
INDEX_LEAVES = ("senders", "receivers", "graph_id")


@pytest.mark.parametrize("multi_pod,arch,shape", [
    (False, a, s) for a, s in S.all_cells()] + [
    (True, a, s) for a, s in MULTI_POD_CELLS])
def test_fitted_shard_shapes_match_the_reference(reference_shards,
                                                 multi_pod, arch, shape):
    want = reference_shards.result()[f"{multi_pod}/{arch}/{shape}"]
    got = port_shards(arch, shape, multi_pod)
    gnn = S.get_arch(arch).family == "gnn"
    common = set(want) & set(got)
    if gnn:       # parameters by module name against nested dicts
        want = {k: v for k, v in want.items() if k.startswith("2.")}
    # the port's DSPC Graph keeps m2 as a host int (launch.steps' doc)
    want = {k: v for k, v in want.items() if not k.endswith(".m2")}
    assert set(want) <= common, sorted(set(want) - common)[:5]
    for k in want:
        assert got[k][0] == want[k][0], (k, got[k], want[k])
        if got[k][1] != want[k][1]:
            assert gnn and k.split(".")[-1] in INDEX_LEAVES, (k, got[k],
                                                              want[k])
            assert (got[k][1], want[k][1]) == ("int64", "int32")
