"""The port's distributed DSPC (``repro_torch.launch.mesh``,
``repro_torch.core.distributed`` and the mesh modes of the driver and
the serving stack) against the JAX package's mesh modes, on the CPU.

A mesh of repeated ``cpu`` entries gives 1 to 8 edge shards in one
process, as the reference's tests get them from forced host devices:
``pad_graph_for`` equals the reference's leaf for leaf; the sharded
relaxations equal ``edge_relax`` / ``multi_edge_relax`` exactly at
edge counts that do not divide; ``DynamicSPC(mesh=)`` leaves
``state_dict()`` byte-identical to the port's single-device engine and
to the reference's mesh mode after the build and after every event
chunk (the reference's 4-device mesh runs in a subprocess with 4 forced
host devices); the sharded query equals ``batched_query`` at every
batch size on a (2, 2) mesh; and the reference's mesh cases of
``tests/serve/test_{engine,publish,service}.py`` hold for the port's
engine, store and service.  A port replica over a mesh serves a JAX
updater's ``DirTransport`` versions with the reference's answers.  The
serving tests run under the runtime shadow lock checker."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.core import graph as JG
from repro.core.distributed import pad_graph_for as jax_pad_graph_for
from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.serve import SPCService as JaxService
from repro_torch.core import graph as G
from repro_torch.core.bfs import edge_relax, multi_edge_relax, plain_spc_bfs
from repro_torch.core.distributed import (ShardedRelax, make_sharded_query,
                                          make_distributed_builder,
                                          make_distributed_updater,
                                          pad_graph_for, replicas_of,
                                          replicate_index)
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.core.graph import INF, edge_set
from repro_torch.core.labels import recompute_cnt_sum
from repro_torch.core.query import batched_query
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,
                                     make_production_mesh, mesh_chips)
from repro_torch.serve import QueryEngine, RoutePolicy, SPCService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
# pendant edge (2, N - 1): deg(N - 1) == 1, for the isolated fast path
EDGES = random_graph_edges(N - 1, 26, seed=0) + [(2, N - 1)]
WAIT = 20.0


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def jax_state(svc):
    return {k: np.asarray(v) for k, v in svc.state_dict().items()}


def assert_state_equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert a.tobytes() == b.tobytes(), (what, k)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def shadow_locks(monkeypatch):
    monkeypatch.setenv("REPRO_SHADOW_LOCKS", "1")


# -- the mesh ---------------------------------------------------------------
def test_mesh_is_a_named_hashable_grid():
    mesh = cpu_mesh((2, 3), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 3}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.axis_names == ("data", "model") and mesh_chips(mesh) == 6
    assert mesh == cpu_mesh((2, 3), ("data", "model"))
    assert hash(mesh) == hash(cpu_mesh((2, 3), ("data", "model")))
    assert mesh != cpu_mesh((3, 2), ("data", "model"))
    assert mesh.distinct_devices == (torch.device("cpu"),)
    # "cpu:0" is the device CPU tensors report: one distinct device
    assert make_mesh((2,), ("x",), ["cpu", "cpu:0"]).distinct_devices == \
        (torch.device("cpu"),)
    assert len(mesh.axis_devices(("model",))) == 3
    assert len(mesh.axis_devices(("data", "model"))) == 6
    with pytest.raises(ValueError, match="not on the mesh"):
        mesh.axis_devices(("pod",))
    with pytest.raises(AttributeError):
        mesh.axis_names = ("a", "b")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="distinct"):
        Mesh(np.asarray([["cpu"]], dtype=object), ("x", "x"))
    assert make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    assert make_production_mesh(devices=["cpu"] * 32).shape == \
        {"data": 2, "model": 16}
    assert make_production_mesh(multi_pod=True, devices=["cpu"] * 4).shape \
        == {"pod": 2, "data": 1, "model": 2}
    with pytest.raises(ValueError, match="do not fill"):
        make_production_mesh(devices=["cpu"] * 24)
    with pytest.raises(ValueError, match="do not fill"):
        make_production_mesh(multi_pod=True, devices=["cpu"])
    if not torch.cuda.is_available():
        for build in (lambda: make_mesh((1,), ("x",)), make_host_mesh,
                      make_production_mesh):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()


# -- the edge-sharded relaxation ----------------------------------------------
@pytest.mark.parametrize("shards", [1, 3, 4, 8])
def test_pad_graph_for_matches_reference(shards):
    edges = random_graph_edges(20, 37, seed=4)
    ours = pad_graph_for(G.from_edges(20, edges, cap_e=90, device="cpu"),
                         shards)
    theirs = jax_pad_graph_for(JG.from_edges(20, edges, cap_e=90), shards)
    assert ours.cap_e % shards == 0 and ours.m2 == int(theirs.m2)
    for name in ("src", "dst"):
        a, b = host(getattr(ours, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_sharded_relax_equals_edge_relax(shards):
    rng = np.random.default_rng(shards)
    n, e = 50, 203                       # 203 divides by none of 2-8
    src = torch.from_numpy(rng.integers(0, n + 1, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n + 1, e).astype(np.int32))
    mesh = cpu_mesh((shards,), ("model",))
    relax = make_distributed_updater(mesh, "model").relax_fn
    multi = make_distributed_updater(mesh, "model").multi_relax_fn
    assert isinstance(relax, ShardedRelax) and relax.num_shards == shards
    placed, reduced = relax.placements, relax.reductions
    for level in range(3):
        cnt = torch.from_numpy(rng.integers(0, 1 << 40, n + 1))
        frontier = torch.from_numpy(rng.random(n + 1) < 0.4)
        # a fresh view of the same edge list each level (as each BFS
        # slices the live prefix): placed once
        got = relax(src[:e], dst[:e], cnt, frontier)
        assert got.dtype == torch.int64
        assert torch.equal(got, edge_relax(src, dst, cnt, frontier))
        cnt_b = torch.from_numpy(rng.integers(0, 1 << 40, (5, n + 1)))
        front_b = torch.from_numpy(rng.random((5, n + 1)) < 0.4)
        assert torch.equal(multi(src, dst, cnt_b, front_b),
                           multi_edge_relax(src, dst, cnt_b, front_b))
    assert relax.placements == placed + 1
    assert relax.reductions == reduced + 3
    # a new graph version is placed anew; fewer edges than shards work
    src2 = src.clone()
    src2[0] = n
    assert torch.equal(relax(src2[:2], dst[:2], cnt, frontier),
                       edge_relax(src2[:2], dst[:2], cnt, frontier))
    assert relax.placements == placed + 2


def test_updater_is_memoised_and_checks_its_axis():
    mesh = cpu_mesh((2, 2), ("data", "model"))
    up = make_distributed_updater(mesh, "model")
    assert make_distributed_updater(cpu_mesh((2, 2), ("data", "model")),
                                    "model") is up
    assert make_distributed_builder(mesh) is up.build_index
    assert up.num_shards == 2 and up.pad(G.from_edges(
        4, [(0, 1)], cap_e=17, device="cpu")).cap_e == 18
    with pytest.raises(ValueError, match="edge axis"):
        make_distributed_updater(mesh, "pod")


# -- DynamicSPC(mesh=) ---------------------------------------------------
STREAM = graph_stream(EDGES, N, 6, 6, seed=2)


@pytest.fixture(scope="module")
def jax_mesh_states():
    """The reference's mesh mode (1-device mesh, in process): the state
    after the build and after every chunk of 4, for both builders."""
    mesh = JaxMesh(np.asarray(jax.devices()[:1]), ("model",))
    out = {}
    for cb in (None, 4):
        ref = JaxDSPC(N, EDGES, l_cap=4, mesh=mesh, construct_batch=cb)
        states = [jax_state(ref)]
        for lo in range(0, len(STREAM), 4):
            ref.apply_events(STREAM[lo:lo + 4], batch_size=4)
            states.append(jax_state(ref))
        out[cb] = states
    return out


@pytest.mark.parametrize("construct_batch", [None, 4])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_mesh_state_matches_reference_and_single_device(
        jax_mesh_states, shards, construct_batch):
    want = jax_mesh_states[construct_batch]
    mesh = cpu_mesh((shards,), ("model",))
    sh = DynamicSPC(N, EDGES, l_cap=4, mesh=mesh, device="cpu",
                    construct_batch=construct_batch)
    rep = DynamicSPC(N, EDGES, l_cap=4, device="cpu",
                     construct_batch=construct_batch)
    assert_state_equal(sh.state_dict(), want[0], "build")
    assert_state_equal(rep.state_dict(), want[0], "build, single device")
    for k, lo in enumerate(range(0, len(STREAM), 4)):
        sh.apply_events(STREAM[lo:lo + 4], batch_size=4)
        rep.apply_events(STREAM[lo:lo + 4], batch_size=4)
        assert_state_equal(sh.state_dict(), want[k + 1], f"chunk {k}")
        assert_state_equal(rep.state_dict(), want[k + 1], f"chunk {k}")
    assert sh.stats.snapshot() == rep.stats.snapshot()
    assert sh.stats.label_regrows > 0


def test_mesh_per_event_paths_and_restore():
    """Inserts, a full deletion, the isolated-vertex fast path and a
    batched insert through the sharded engines, then ``from_state_dict``
    and ``from_checkpoint`` into mesh mode: bit-identical to one device,
    and the edge arrays padded to the shard count (3 does not divide the
    power-of-two capacities)."""
    mesh = cpu_mesh((3,), ("model",))
    sh = DynamicSPC(N, EDGES, l_cap=N + 2, mesh=mesh, device="cpu")
    rep = DynamicSPC(N, EDGES, l_cap=N + 2, device="cpu")
    assert sh.graph.cap_e % 3 == 0 and sh.graph.cap_e != rep.graph.cap_e

    def same(tag):
        a, b = sh.state_dict(), rep.state_dict()
        for k in b:
            if not k.startswith("graph."):
                assert a[k].tobytes() == b[k].tobytes(), (tag, k)
        assert edge_set(sh.graph) == edge_set(rep.graph), tag
        assert sh.graph.cap_e % 3 == 0, tag

    absent = [(a, b) for a in range(N - 1) for b in range(a + 1, N - 1)
              if (a, b) not in edge_set(rep.graph)]
    for spc in (sh, rep):
        spc.insert_edge(*absent[0])
        spc.delete_edge(*EDGES[0])
        spc.delete_edge(2, N - 1)           # isolated fast path
        spc.insert_edges(absent[1:4])
    same("per-event")
    assert sh.stats.isolated_fast_path == 1
    back = DynamicSPC.from_state_dict(N, rep.state_dict(), mesh=mesh,
                                      device="cpu")
    assert back.graph.cap_e % 3 == 0
    back.apply_events(STREAM[:0] + [("+",) + absent[4]], batch_size=4)
    rep.apply_events([("+",) + absent[4]], batch_size=4)
    for k, v in rep.state_dict().items():
        if not k.startswith("graph."):
            assert back.state_dict()[k].tobytes() == v.tobytes(), k


SUBPROCESS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.core.dynamic import DynamicSPC
    from repro.data import graph_stream, random_graph_edges

    assert len(jax.devices()) == 4, jax.devices()
    n = 16
    edges = random_graph_edges(n - 1, 26, seed=0) + [(2, n - 1)]
    stream = graph_stream(edges, n, 6, 6, seed=2)
    out = {}
    for shards in (3, 4):
        mesh = Mesh(np.asarray(jax.devices()[:shards]), ("model",))
        svc = DynamicSPC(n, edges, l_cap=4, mesh=mesh)
        for lo in (0, 4, 8):
            svc.apply_events(stream[lo:lo + 4], batch_size=4)
        for k, v in svc.state_dict().items():
            out[f"{shards}/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("REF_MESH_OK")
""")


def test_four_shards_match_the_reference_four_device_mesh(tmp_path):
    """The reference's 3- and 4-device meshes (forced host devices, in a
    subprocess) against the port's 3- and 4-shard ``cpu`` meshes: the
    same states byte for byte, the padded edge arrays included."""
    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SUBPROCESS, path],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert "REF_MESH_OK" in proc.stdout, proc.stderr[-3000:]
    ref = np.load(path)
    for shards in (3, 4):
        svc = DynamicSPC(N, EDGES, l_cap=4, device="cpu",
                         mesh=cpu_mesh((shards,), ("model",)))
        for lo in (0, 4, 8):
            svc.apply_events(STREAM[lo:lo + 4], batch_size=4)
        want = {k.split("/", 1)[1]: ref[k] for k in ref.files
                if k.startswith(f"{shards}/")}
        assert_state_equal(svc.state_dict(), want, f"{shards} shards")


# -- sharded serving --------------------------------------------------------
@pytest.fixture(scope="module")
def lived():
    svc = DynamicSPC(N, EDGES, l_cap=N + 2, device="cpu")
    svc.apply_events(STREAM, batch_size=4)
    return svc


@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
@pytest.mark.parametrize("b", [0, 1, 7, 64])
def test_sharded_query_equals_batched_query(lived, axes, b):
    mesh = cpu_mesh((2, 2), ("data", "model"))
    shards = int(np.prod([mesh.shape[a] for a in axes]))
    rng = np.random.default_rng(b)
    s = torch.from_numpy(rng.integers(0, N, b))
    t = torch.from_numpy(rng.integers(0, N, b))
    d0, c0 = batched_query(lived.index, s, t)
    if b % shards:
        with pytest.raises(ValueError, match="does not divide"):
            make_sharded_query(mesh, axes)(lived.index, s, t)
    else:
        d, c = make_sharded_query(mesh, axes)(lived.index, s, t)
        assert torch.equal(d, d0) and torch.equal(c, c0)
    eng = QueryEngine()
    d, c = eng.sharded(mesh, axes)(lived.index, s.numpy(), t.numpy())
    assert d.dtype == torch.int32 and c.dtype == torch.int64
    assert torch.equal(d, d0) and torch.equal(c, c0)
    key = f"sharded[{'x'.join(axes)}]:merge"
    assert dict(eng.stats.snapshot().routes) == ({key: 1} if b else {})
    assert eng.stats.queries == b


def test_sharded_serve_validates_route(lived):
    """``tests/serve/test_engine.py:224-275``: unknown routes raise, a
    route the sharded path cannot honour raises (per call or configured
    on the engine), B = 0 makes no dispatch, and a sharded policy cannot
    run on the single-device path."""
    mesh = cpu_mesh((2, 2), ("data", "model"))
    serve = QueryEngine().sharded(mesh)
    with pytest.raises(ValueError, match="unknown route"):
        serve(lived.index, [0], [1], route="bogus")
    for route in ("table", "kernel", "pallas"):
        with pytest.raises(ValueError, match="not available on the sharded"):
            serve(lived.index, [0], [1], route=route)
        with pytest.raises(ValueError, match="sharded"):
            QueryEngine(route=route).sharded(mesh)(lived.index, [0], [1])
    eng = QueryEngine(route="merge")
    d, c = eng.sharded(mesh)(lived.index, [0], [0])
    assert (int(d[0]), int(c[0])) == (0, 1)
    eng = QueryEngine()
    d, c = eng.sharded(mesh)(lived.index, [], [])
    assert d.shape == (0,) and c.shape == (0,) and eng.stats.batches == 0
    with pytest.raises(ValueError, match="unknown route"):
        eng.sharded(mesh)(lived.index, [], [], route="bogus")
    with pytest.raises(ValueError, match="out of range"):
        eng.sharded(mesh)(lived.index, [N], [0])
    with pytest.raises(ValueError, match="single-device"):
        eng.query_batch(lived.index, [0], [1], route=RoutePolicy.sharded())
    with pytest.raises(ValueError, match="single-device"):
        eng.query_batch(lived.index, [0], [1], route="sharded")


def test_replicate_index_one_copy_per_distinct_device(lived):
    mesh = cpu_mesh((2, 2), ("data", "model"))
    assert replicate_index(mesh, lived.index) is lived.index
    assert replicas_of(lived.index) == {torch.device("cpu"): lived.index}


@pytest.mark.parametrize("use_mesh", [False, True])
def test_cached_bound_differential_vs_bfs(use_mesh, shadow_locks):
    """``tests/serve/test_publish.py:288``: ``cnt_sum`` stays exact under
    the single-device and the sharded engines, and the served answers
    equal the counting BFS."""
    n = 24
    edges = random_graph_edges(n, 55, seed=7)
    mesh = cpu_mesh((4,), ("model",)) if use_mesh else None
    svc = DynamicSPC(n, edges, l_cap=32, mesh=mesh, device="cpu")
    svc.apply_events(graph_stream(edges, n, 8, 4, seed=8), batch_size=4)
    assert torch.equal(svc.index.cnt_sum, recompute_cnt_sum(svc.index.cnt))
    eng = QueryEngine()
    serve = eng.serve_from(svc.attach_store())
    rng = np.random.default_rng(9)
    s, t = rng.integers(0, n, 40), rng.integers(0, n, 40)
    d, c = serve(s, t)
    for k, (sk, tk) in enumerate(zip(s, t)):
        res = plain_spc_bfs(svc.graph, int(sk))
        if int(res.dist[tk]) >= INF:
            assert int(c[k]) == 0 and int(d[k]) >= INF
        else:
            assert (int(d[k]), int(c[k])) == (int(res.dist[tk]),
                                              int(res.cnt[tk]))


def test_mesh_store_replicates_and_serves(lived, shadow_locks):
    """``tests/serve/test_publish.py:313``: a mesh-placed store stages
    each snapshot over the serving mesh; ``serve_from(mesh=)`` answers
    as the routed path and counts versions."""
    mesh = cpu_mesh((2, 2), ("data", "model"))
    svc = DynamicSPC.from_state_dict(N, lived.state_dict(), device="cpu")
    store = svc.attach_store(mesh=mesh)
    eng = QueryEngine()
    serve = eng.serve_from(store, mesh=mesh)
    present = sorted(edge_set(svc.graph))
    svc.apply_events([("-",) + present[0], ("+",) + present[0]],
                     batch_size=4)
    rng = np.random.default_rng(10)
    s, t = rng.integers(0, N, 13), rng.integers(0, N, 13)
    d, c = serve(s, t)
    d0, c0 = QueryEngine().query_batch(svc.index, s, t, route="merge")
    assert torch.equal(d, d0) and torch.equal(c, c0)
    v = lived.version + 1
    assert dict(eng.stats.routes) == {"sharded[data]:merge": 1}
    assert dict(eng.stats.versions) == {v: 13}


def _service(**kw):
    kw.setdefault("l_cap", 32)
    kw.setdefault("wait_timeout", WAIT)
    return SPCService(N, EDGES, device="cpu", **kw)


def test_service_differential_vs_oracle_on_meshes(shadow_locks):
    """``tests/serve/test_service.py:108``: the façade's answers equal the
    counting BFS across a mutation stream with the updater edge-sharded
    and the snapshots served sharded."""
    mesh = cpu_mesh((2, 2), ("data", "model"))
    with _service(mesh=mesh, serve_mesh=mesh, route="sharded",
                  update_batch=4) as svc:
        rng = np.random.default_rng(7)
        events = graph_stream(sorted(edge_set(svc.spc.graph)), N, 8, 4,
                              seed=8)
        for lo in range(0, len(events), 4):
            svc.submit(events[lo:lo + 4])
        svc.drain()
        assert svc.version == svc.spc.version > 0
        s, t = rng.integers(0, N, 40), rng.integers(0, N, 40)
        d, c = svc.reader("read_your_writes")(s, t)
        for k, (sk, tk) in enumerate(zip(s, t)):
            res = plain_spc_bfs(svc.spc.graph, int(sk))
            assert (int(d[k]), int(c[k])) == (int(res.dist[tk]),
                                              int(res.cnt[tk]))
        assert svc.stats()["serve"][0].routes == {"sharded[data]:merge": 1}


def test_sharded_policy_reader_matches_routed_path(shadow_locks):
    """``tests/serve/test_service.py:481``."""
    mesh = cpu_mesh((2,), ("data",))
    with _service(serve_mesh=mesh) as svc:
        present = sorted(edge_set(svc.spc.graph))
        svc.submit([("-",) + present[1]])
        svc.drain()
        serve = svc.reader(route=RoutePolicy.sharded())
        rng = np.random.default_rng(9)
        s, t = rng.integers(0, N, 13), rng.integers(0, N, 13)
        d, c = serve(s, t)
        d0, c0 = QueryEngine().query_batch(svc.spc.index, s, t,
                                           route="merge")
        assert torch.equal(d, d0) and torch.equal(c, c0)
        assert serve.engine.stats.snapshot().routes == \
            {"sharded[data]:merge": 1}
    with pytest.raises(ValueError, match="serve_mesh"):
        _service(route=RoutePolicy.sharded())
    with _service() as svc:
        with pytest.raises(ValueError, match="serve_mesh"):
            svc.reader(route="sharded")


def test_sharded_route_respects_service_axes_and_default_route(
        shadow_locks):
    """``tests/serve/test_service.py:509``: the string ``"sharded"``
    binds the service's batch_axes; a policy naming an axis the mesh
    lacks fails when the reader is built; a sharded reader over replicas
    defaulting to the table route still serves the merge core."""
    mesh = cpu_mesh((2,), ("x",))
    with _service(serve_mesh=mesh, batch_axes=("x",), route="table") as svc:
        serve = svc.reader(route="sharded")
        d, c = serve([0, 1], [2, 3])
        assert d.shape == (2,)
        assert serve.engine.stats.snapshot().routes == {"sharded[x]:merge": 1}
        with pytest.raises(ValueError, match="batch axes"):
            svc.reader(route=RoutePolicy.sharded(("data",)))


def test_mesh_replica_serves_a_jax_updaters_versions(tmp_path, shadow_locks):
    """A JAX updater publishes through a directory; a port replica with
    ``serve_mesh=`` pulls every version, stages it over the mesh and
    answers through the sharded route exactly as the updater's own
    reader at that version."""
    d = str(tmp_path)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    updater = JaxService(N, EDGES, l_cap=32, update_batch=4,
                         transport="dir", publish_dir=d, keep_published=2,
                         wait_timeout=WAIT)
    replica = SPCService(role="replica", publish_dir=d, serve_mesh=mesh,
                         route="sharded", poll_interval_s=0.01,
                         wait_timeout=WAIT, device="cpu")
    events = graph_stream(EDGES, N, 4, 2, seed=5)
    rng = np.random.default_rng(0)
    with updater, replica:
        own = updater.reader("pinned")
        for lo in range(-3, len(events), 3):
            if lo >= 0:
                updater.submit(events[lo:lo + 3])
            updater.drain()
            replica.drain()
            assert replica.version == updater.version
            s, t = rng.integers(0, N, 21), rng.integers(0, N, 21)
            dw, cw = own(s, t)
            dg, cg = replica.query_batch(s, t)
            np.testing.assert_array_equal(host(dg), np.asarray(dw))
            np.testing.assert_array_equal(host(cg), np.asarray(cw))
        st = replica.stats()
        assert st["version"] == 2 and st["replica"]["errors"] == 0
        assert dict(st["serve"][0].routes) == {"sharded[data]:merge": 3}


def test_chip_smoke_distributed_phase_on_the_cpu(shadow_locks):
    """``chip_smoke.py``'s phase D at a small size on the CPU (four
    ``cpu`` entries on each axis): every check of the phase holds, the
    sharded serving counts every batch on ``sharded[data]:merge`` and
    the phase's counters launch no kernel.  The phase builds its graph
    on one device itself and holds the sharded build against it."""
    import chip_smoke
    from repro_torch.kernels import common
    n, m = 48, 150
    edges = chip_smoke.power_law_edges(n, m, 0)
    build_kw = dict(l_cap=None, construct_batch=8, vertex_order="id")
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in ("spc_query", "segment_matmul",
                                              "embedding_bag",
                                              "flash_decode")})
    out = chip_smoke.distributed_phase(edges, n, build_kw, counts, 0,
                                       "the CPU", device="cpu")
    assert out["entries"] == chip_smoke.DIST_SHARDS
    assert (out["n"], out["m"]) == (n, len(edges))
    assert out["build_syncs"] == out["single_build"]["syncs"]
    assert out["distinct_devices"] == 1
    assert out["serve_routes"] == {
        "sharded[data]:merge": chip_smoke.DIST_BATCHES + 1}
    assert set(out["service"]["routes"]) == {"sharded[data]:merge"}
    assert out["chunk"]["sharded"]["syncs"] == out["chunk"]["single"]["syncs"]
    assert out["build_syncs"] > 0
    assert not any(counts.of(k)[0] for k in counts.counters)
    assert chip_smoke.PATH_KERNELS["distributed"] == ()
