"""The port's slices end to end, and their boundaries.

* build -> maintain -> serve at the ``dspc`` SMOKE configuration in both
  packages: identical state after the build and after every event chunk,
  identical answers on every route;
* section 3 of ``examples/analytics_spc.py`` (recommendation -> PNA
  re-rank with ``embedding_bag`` pooling) in both packages on the same
  snapshot, weights and table: the same candidates, the same order, and
  scores within the PNA tolerance (rtol 1e-4, atol 1e-5);
* the oracles ``chip_smoke.py`` checks the analytics path with agree
  with the port's analytics;
* the port (and ``chip_smoke.py``) imports neither JAX nor ``repro``;
* ``chip_smoke.py`` refuses to run without a card, or without the
  repository beside it, and prints no result then;
* ``chip_smoke.py``'s LM path (grouped prefill, greedy decode, the
  decode / prefill consistency check) at qwen2-1.5b ``SMOKE`` on the
  CPU, its flash_decode byte count and its launch counting by path;
* the port's copies of the configuration and the data generators agree
  with the reference's."""

import ast
import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from repro.analytics import AnalyticsEngine as JaxAnalytics
from repro.configs.dspc import CONFIG as JAX_CONFIG
from repro.configs.dspc import SMOKE as JAX_SMOKE
from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.data import graph_stream as jax_graph_stream
from repro.data import random_graph_edges as jax_random_graph_edges
from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag
from repro.models.gnn.pna import PNAConfig as JaxPNAConfig
from repro.models.gnn.pna import forward as jax_pna_forward
from repro.models.gnn.pna import init_params as jax_pna_init
from repro.serve import QueryEngine as JaxEngine
from repro.serve.publish import SnapshotStore as JaxStore
from repro_torch.analytics import AnalyticsEngine
from repro_torch.bench import kernels_bench
from repro_torch.configs.dspc import CONFIG, SMOKE
from repro_torch.configs.pna import CONFIG as PNA_CONFIG
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels import common
from repro_torch.models.gnn.pna import PNA
from repro_torch.serve import QueryEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_state_equal(want, got, what):
    assert sorted(want) == sorted(got), what
    for k in want:
        assert np.asarray(want[k]).dtype == got[k].dtype, (what, k)
        assert np.asarray(want[k]).tobytes() == got[k].tobytes(), (what, k)


def test_config_and_generators_match_reference():
    for mine, ref in ((CONFIG, JAX_CONFIG), (SMOKE, JAX_SMOKE)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    edges = random_graph_edges(50, 120, seed=4)
    assert edges == jax_random_graph_edges(50, 120, seed=4)
    assert random_graph_edges(30, 40, seed=1, power_law=False) == \
        jax_random_graph_edges(30, 40, seed=1, power_law=False)
    assert graph_stream(edges, 50, 9, 7, seed=5) == \
        jax_graph_stream(edges, 50, 9, 7, seed=5)


def test_smoke_slice_build_maintain_serve():
    cfg = SMOKE
    edges = random_graph_edges(cfg.n, cfg.m, seed=0)
    kw = dict(l_cap=None, construct_batch=cfg.construct_batch,
              vertex_order=cfg.vertex_order)
    j = JaxDSPC(cfg.n, edges, **kw)
    t = DynamicSPC(cfg.n, edges, device="cpu", **kw)
    assert_state_equal(j.state_dict(), t.state_dict(), "build")
    half = cfg.update_batch // 2
    events = graph_stream(edges, cfg.n, 2 * half, 2 * half, seed=1)
    for lo in range(0, len(events), cfg.update_batch):
        chunk = events[lo:lo + cfg.update_batch]
        j.apply_events(chunk, batch_size=cfg.update_batch)
        t.apply_events(chunk, batch_size=cfg.update_batch)
        assert_state_equal(j.state_dict(), t.state_dict(), f"chunk {lo}")
    rng = np.random.default_rng(2)
    s = rng.integers(0, cfg.n, cfg.query_batch)
    tt = rng.integers(0, cfg.n, cfg.query_batch)
    dj, cj = JaxEngine().query_batch(j.index, s, tt)
    eng = QueryEngine()
    for route in ("auto", "kernel"):
        d, c = eng.query_batch(t.index, s, tt, route=route)
        np.testing.assert_array_equal(host(d), host(dj))
        np.testing.assert_array_equal(host(c), host(cj))
    assert dict(eng.stats.routes) == {"merge": 1, "kernel": 1}


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_script_import_no_jax_or_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("IMPORTED", " ".join(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = proc.stdout.split("IMPORTED")[-1].split()
    assert len(imported) >= 20
    assert {"repro_torch.bench.kernels_bench",
            "repro_torch.kernels.segment_matmul.kernel",
            "repro_torch.kernels.segment_matmul.ops",
            "repro_torch.kernels.segment_matmul.ref",
            "repro_torch.core.directed", "repro_torch.train.checkpoint",
            "repro_torch.serve.transport", "repro_torch.serve.replica",
            "repro_torch.serve.service",
            "repro_torch.serve.frontdoor", "repro_torch.models.moe",
            "repro_torch.models.attention",
            "repro_torch.configs.qwen2_7b",
            "repro_torch.configs.phi3_medium_14b",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.models.dien", "repro_torch.configs.dien",
            "repro_torch.train.optimizer", "repro_torch.train.loop",
            "repro_torch.data.pipelines", "repro_torch.sharding",
            "repro_torch.models.gnn.ring", "repro_torch.core.refimpl",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            *(f"repro_torch.examples.{name}" for name in (
                "quickstart", "dynamic_stream", "serve_spc", "fleet_spc",
                "analytics_spc", "gnn_molecule", "serve_lm",
                "train_lm")),
            *(f"repro_torch.analysis.{name}" for name in (
                "cli", "rules", "lockorder", "baseline", "findings",
                "__main__"))} <= set(imported)
    scanned = {os.path.relpath(f, PORT) for f in files}
    assert {"bench/kernels_bench.py", "kernels/segment_matmul/ops.py",
            "core/directed.py", "train/checkpoint.py", "serve/replica.py",
            "serve/service.py", "serve/frontdoor.py", "models/moe.py",
            "models/attention.py", "configs/qwen2_7b.py",
            "configs/phi3_medium_14b.py", "configs/deepseek_v2_lite_16b.py",
            "configs/deepseek_v2_236b.py", "models/dien.py", "configs/dien.py",
            "train/optimizer.py", "train/loop.py",
            "data/pipelines.py", "sharding.py",
            "models/gnn/ring.py", "core/refimpl.py", "launch/steps.py",
            "launch/train.py", "examples/quickstart.py",
            "examples/fleet_spc.py", "examples/serve_lm.py",
            *(f"analysis/{name}.py" for name in (
                "cli", "rules", "lockorder", "baseline", "findings",
                "__main__"))} <= scanned


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Here (no CUDA device) and alone in a directory, the script exits
    non-zero and prints no result line."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    # beside the repository it needs a card; where there is one, that
    # run is the real smoke run, which this test does not start
    cwds = [str(alone)] + ([] if torch.cuda.is_available() else [REPO])
    for cwd in cwds:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


def test_chip_smoke_bound_counts_the_rows_work():
    """The kernel's bound reads both hub rows in full but dist and cnt
    only at the common hubs, counted on the run's own rows."""
    import chip_smoke
    from repro_torch.kernels.spc_query.ops import prep_rows
    n = 40
    svc = DynamicSPC(n, random_graph_edges(n, 90, seed=3), device="cpu")
    rng = np.random.default_rng(5)
    s, t = (torch.from_numpy(rng.integers(0, n, 64)) for _ in range(2))
    rows = prep_rows(svc.index, s, t)
    hub_s, dist_s, _, hub_t, dist_t, _ = (host(r) for r in rows)
    b, l_cap = hub_s.shape
    common = sum(len(set(hub_s[r]) & set(hub_t[r])) for r in range(b))
    real = int((dist_s < (1 << 28)).sum() + (dist_t < (1 << 28)).sum())
    assert common > 0
    assert chip_smoke.spc_query_work(rows) == (
        2 * b * l_cap * 4 + 24 * common + 12 * b, real + 4 * common, common)
    # the kernel table reckons K4's bound by flash_decode's cost:
    # qwen2-1.5b's main shape (B 16, H 12, KVH 2, S 32832, D 128, bf16)
    from repro_torch.kernels.flash_decode.kernel import cost
    ops, nbytes = cost(16, 12, 2, 32832, 128, torch.bfloat16)
    assert round(chip_smoke.bound_ms(nbytes, ops)[0], 5) == 0.16060


def test_kernel_build_is_lazy_and_keyed_by_source(monkeypatch):
    path = common.library_path("spc_query")
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("libspc_query-") and path.suffix == ".so"
    assert "spc_query" not in common._loaded  # nothing built at import
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(REPO))  # no bin/nvcc there
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common._nvcc()


def test_example_rerank_in_both_packages():
    """Section 3 of examples/analytics_spc.py at the full PNA width
    (configs/pna.py CONFIG, d_in = 4) in both packages on the same
    snapshot, weights and embedding table."""
    path = os.path.join(REPO, "examples", "analytics_spc.py")
    spec = importlib.util.spec_from_file_location("analytics_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    n = 80
    edges = random_graph_edges(n, 240, seed=0)
    j = JaxDSPC(n, edges, l_cap=32)
    t = DynamicSPC.from_state_dict(
        n, {k: np.asarray(v) for k, v in j.state_dict().items()},
        device="cpu")
    jview = JaxAnalytics(JaxStore(j.index)).pin()
    tview = AnalyticsEngine(t.attach_store()).pin()
    u = int(np.argmax(np.asarray(jview.index.size)[:n]))
    recs = tview.recommend(u)
    assert [dataclasses.astuple(r) for r in recs] == \
        [dataclasses.astuple(r) for r in jview.recommend(u)]
    cand = np.asarray([r.vertex for r in recs])
    assert len(cand) > 3

    cfg = JaxPNAConfig(n_layers=PNA_CONFIG.n_layers,
                       d_hidden=PNA_CONFIG.d_hidden, d_in=4)
    params = jax_pna_init(cfg, jax.random.PRNGKey(0))
    table = np.random.default_rng(1).standard_normal((n, 8)).astype(
        np.float32)
    batch, sub, local = example.ego_batch(jview, u, cand, cfg.d_in)
    node_scores = np.asarray(jax_pna_forward(params, batch, cfg))[:, 0]
    ids = [jview.common_neighbor_ids(u, int(x)) for x in cand]
    padded = np.full((len(cand), max(max(len(i) for i in ids), 1)), n,
                     dtype=np.int32)
    for row, i in zip(padded, ids):
        row[:len(i)] = i
    np.testing.assert_array_equal(
        chip_smoke.common_friend_bags(tview, u, cand), padded)
    pooled = np.asarray(jax_bag(jnp.asarray(padded), jnp.asarray(table),
                                mode="mean", pad_id=n))
    want = node_scores[[local[int(x)] for x in cand]] + pooled.mean(axis=1)

    pna = PNA(dataclasses.replace(PNA_CONFIG, d_in=4), device="cpu")
    pna.load_reference_params(jax.tree.map(np.asarray, params))
    got_cand, got, sub_n = chip_smoke.rerank(tview, u, recs, pna,
                                             torch.from_numpy(table))
    np.testing.assert_array_equal(got_cand, cand)
    assert sub_n == len(sub)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.argsort(-got, kind="stable"),
                                  np.argsort(-want, kind="stable"))


def test_chip_smoke_analytics_oracles_agree_with_the_port():
    """The edge-list and BFS oracles chip_smoke.py holds the analytics
    path against, run on the CPU beside the port's answers."""
    n = 120
    edges = chip_smoke.power_law_edges(n, 400, 0)
    svc = DynamicSPC(n, edges, device="cpu", construct_batch=8)
    eng = AnalyticsEngine(svc.attach_store(), pair_sample=40, top_k=6)
    pairs = eng.sample_pairs()
    maint = eng.betweenness_maintainer(pairs)
    svc.apply_events(graph_stream(edges, n, 4, 4, seed=0), batch_size=8)
    maint.refresh()
    want = chip_smoke.bfs_betweenness(svc.graph, *pairs)
    chip_smoke.check_close("bc", torch.from_numpy(maint.scores()), want,
                           1e-9, 1e-9)
    view = eng.pin()
    for v in range(0, n, 9):
        cyc = view.cycles_through_vertex(v)
        assert (cyc.odd_count, cyc.even_count) == \
            chip_smoke.edge_list_cycles(svc.graph, v), v
        assert [(r.vertex, r.score) for r in view.recommend(v)] == \
            chip_smoke.edge_list_recommend(svc.graph, v, 6), v
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.check_close("x", want + 1.0, want, 1e-9, 1e-9)


def test_chip_smoke_bag_bound_counts_distinct_rows():
    ids = torch.tensor([[0, 3, 3, 9], [12, -1, 3, 1]], dtype=torch.int32)
    table = torch.zeros(10, 18)                    # V = 9: row 9 is zero
    nbytes, ops, distinct = chip_smoke.embedding_bag_work(ids, table)
    assert distinct == 4                           # rows 0, 1, 3 and 9
    assert nbytes == 8 * 4 + (4 + 2) * 18 * 4
    assert ops == 2 * 4 * 18
    bound, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "bytes" and bound == 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S


def test_chip_smoke_counts_launches_by_path():
    """Each main path counts only the launches made inside its own
    phases; launches between them (oracles, kernel checks) count
    nowhere, and a path that never launched its kernel fails."""
    sq, eb = common.LaunchCounter("spc_query"), common.LaunchCounter("eb")
    fd = common.LaunchCounter("flash_decode")
    sm = common.LaunchCounter("segment_matmul")
    kernels = {"spc_query": sq, "segment_matmul": sm, "embedding_bag": eb,
               "flash_decode": fd}
    counts = chip_smoke.PathLaunches(kernels)
    with counts.path("dspc"):
        sq.count += 3
    sq.count += 5                                  # an oracle's launches
    with counts.path("kernels"):
        sq.count += 52
        sm.count += 53
    sm.count += 4                                  # a kernel check
    with counts.path("analytics"):
        eb.count += 1
    with counts.path("dspc"):
        sq.count += 2
    eb.count += 7                                  # a kernel check
    with counts.path("lm"):
        fd.count += 8 * 64                         # LM_LAYERS x LM_STEPS
    fd.count += 9                                  # the main-shape check
    with counts.path("service"):
        sq.add(40)                                 # readers and dispatchers
    sq.count += 2                                  # an oracle's launches
    with counts.path("distributed"):
        pass                                       # D launches no kernel
    sq.count += 3                                  # D's comparison route
    with counts.path("qwen2-7b"):
        fd.count += 28 * 16
    with counts.path("phi3-medium-14b"):
        fd.count += 40 * 16
    fd.count += 3                                  # K4 at their shapes
    for path in ("deepseek-v2-lite-16b", "deepseek-v2-236b"):
        with counts.path(path):
            pass                   # MLA decode and the MoE: no kernel
    with counts.path("gnn"):
        pass                       # phase G: segment sums, no kernel
    with counts.path("recsys"):
        pass                       # phase R: DIEN's gathers and means
    eb.count += 2                  # a kernel check between the phases
    with counts.path("train"):
        pass                       # phase T: no kernel has a backward
    fd.count += 6                  # X's unsharded decode and LSE holds
    with counts.path("mesh"):
        fd.count += 28 * 16 * 4    # X1: a launch a layer, step and shard
    with counts.path("tp"):
        fd.count += 28 * 16 * 4    # X5: the same on the tp path
    with counts.path("fsdp"):
        pass                       # X7-X9: no kernel has a backward
    with counts.path("launch"):
        fd.count += 28 * 16        # B2: the decode_32k cell's decode
    with counts.path("examples"):
        sq.count += 30             # E: the DSPC examples' serving
        eb.count += 1              # analytics_spc's re-rank pooling
        fd.count += 2 * 11         # serve_lm's decode steps
    zero = dict.fromkeys(kernels, 0)
    paths = dict.fromkeys(chip_smoke.PATH_KERNELS, 0)
    assert counts.by_path == {
        "dspc": dict(zero, spc_query=5),
        "kernels": dict(zero, spc_query=52, segment_matmul=53),
        "analytics": dict(zero, embedding_bag=1),
        "lm": dict(zero, flash_decode=512),
        "service": dict(zero, spc_query=40),
        "distributed": zero,
        "qwen2-7b": dict(zero, flash_decode=448),
        "phi3-medium-14b": dict(zero, flash_decode=640),
        "deepseek-v2-lite-16b": zero, "deepseek-v2-236b": zero,
        "gnn": zero, "recsys": zero, "train": zero,
        "mesh": dict(zero, flash_decode=1792),
        "tp": dict(zero, flash_decode=1792), "fsdp": zero,
        "launch": dict(zero, flash_decode=448),
        "examples": dict(zero, spc_query=30, embedding_bag=1,
                         flash_decode=22),
        "analysis": zero}
    assert chip_smoke.PATH_KERNELS["recsys"] == () == \
        chip_smoke.PATH_KERNELS["train"] == chip_smoke.PATH_KERNELS["fsdp"]
    assert counts.of("spc_query") == (127, dict(paths, dspc=5, kernels=52,
                                                service=40, examples=30))
    assert counts.of("segment_matmul") == (53, dict(paths, kernels=53))
    assert counts.of("flash_decode") == (
        512 + 448 + 640 + 1792 + 1792 + 448 + 22, dict(
            paths, lm=512, mesh=1792, tp=1792, launch=448, examples=22,
            **{"qwen2-7b": 448, "phi3-medium-14b": 640}))
    assert chip_smoke.LM_LAYERS * chip_smoke.LM_STEPS == 512
    counts.check()
    bare = chip_smoke.PathLaunches(kernels)
    with bare.path("dspc"):
        sq.count += 1
    with bare.path("kernels"):
        sq.count += 1
        sm.count += 1
    with bare.path("lm"):
        fd.count += 1
    with pytest.raises(AssertionError, match="embedding_bag never launched "
                                             "on the analytics path"):
        bare.check()
    no_lm = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("kernels", sm),
                    ("analytics", eb)):
        with no_lm.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="flash_decode never launched "
                                             "on the lm path"):
        no_lm.check()
    no_k2 = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("analytics", eb),
                    ("lm", fd), ("service", sq)):
        with no_k2.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="segment_matmul never launched "
                                             "on the kernels path"):
        no_k2.check()
    no_service = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("kernels", sm),
                    ("analytics", eb), ("lm", fd)):
        with no_service.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="spc_query never launched "
                                             "on the service path"):
        no_service.check()
    no_mesh = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("kernels", sm),
                    ("analytics", eb), ("lm", fd), ("service", sq),
                    ("qwen2-7b", fd), ("phi3-medium-14b", fd)):
        with no_mesh.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="flash_decode never launched "
                                             "on the mesh path"):
        no_mesh.check()
    no_launch = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("kernels", sm),
                    ("analytics", eb), ("lm", fd), ("service", sq),
                    ("qwen2-7b", fd), ("phi3-medium-14b", fd), ("mesh", fd),
                    ("tp", fd), ("examples", sq), ("examples", eb),
                    ("examples", fd)):
        with no_launch.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="flash_decode never launched "
                                             "on the launch path"):
        no_launch.check()
    no_tp = chip_smoke.PathLaunches(kernels)
    for path, c in (("dspc", sq), ("kernels", sq), ("kernels", sm),
                    ("analytics", eb), ("lm", fd), ("service", sq),
                    ("qwen2-7b", fd), ("phi3-medium-14b", fd), ("mesh", fd),
                    ("launch", fd), ("examples", sq), ("examples", eb),
                    ("examples", fd)):
        with no_tp.path(path):
            c.count += 1
    with pytest.raises(AssertionError, match="flash_decode never launched "
                                             "on the tp path"):
        no_tp.check()


def test_launch_counter_counts_every_threaded_increment():
    """Reader, dispatcher and updater threads launch at once: 8 threads
    of 1000 increments each count exactly 8000, and setting the count
    (as the smoke script does before each path) is seen by all."""
    import threading
    counter = common.LaunchCounter("spc_query")
    barrier = threading.Barrier(8)

    def bump():
        barrier.wait(timeout=30)
        for _ in range(1000):
            counter.add()

    threads = [threading.Thread(target=bump) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as can be
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == 8000
    counter.count = 0
    counter.add(3)
    assert counter.count == 3


def test_chip_smoke_flash_decode_bound_counts_valid_rows():
    """K and V are read once per KV head within each row's length,
    whatever the number of query heads that share them."""
    q = torch.zeros(2, 12, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 100, 2, 128, dtype=torch.bfloat16)
    lengths = torch.tensor([100, 30], dtype=torch.int32)
    nbytes, ops = chip_smoke.flash_decode_work(q, k, lengths)
    assert nbytes == 2 * 130 * 2 * 128 * 2 + 2 * (2 * 12 * 128 * 2) + 2 * 4
    assert ops == 4 * 130 * 12 * 128
    q = torch.zeros(16, 12, 128, dtype=torch.bfloat16)
    k = torch.zeros(16, 32832, 2, 128, dtype=torch.bfloat16, device="meta")
    nbytes, ops = chip_smoke.flash_decode_work(
        q, k, torch.full((16,), 32832, dtype=torch.int32))
    bound, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "bytes" and 0.16 < bound < 0.161   # ~537 MB at 3.35 TB/s


def test_chip_smoke_lm_path_on_the_cpu():
    """Grouped prefill equals one prefill of the whole batch; greedy
    decode feeds the prefill's argmax first and grows the cache one
    position a step; a prefill of prompt + fed tokens reproduces the
    last decode step's logits."""
    from repro_torch.configs.qwen2_1_5b import SMOKE as QWEN_SMOKE
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(QWEN_SMOKE, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (5, 12)).astype(np.int32))
    s_max = 12 + 4
    logits, cache = chip_smoke.prefill_in_groups(params, cfg, prompts, s_max,
                                                 2)
    want_logits, want_cache = tf.prefill(params, prompts, cfg, s_max)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name], want_cache[name], rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(cache["lengths"], want_cache["lengths"])
    first = logits.argmax(dim=-1).to(torch.int32)
    fed, last, cache, ms = chip_smoke.greedy_decode(params, cfg, cache, first,
                                                    4)
    assert ms == [] and fed.shape == (5, 4) and torch.equal(fed[:, 0], first)
    assert cache["lengths"].tolist() == [16] * 5
    check_cache = {name: cache[name][:, :2].clone() for name in ("k", "v")}
    check_cache["lengths"] = cache["lengths"][:2].clone()
    l4 = chip_smoke.lm_consistency(params, cfg, prompts[:2], fed[:2],
                                   last[:2], check_cache, s_max, span=4)
    assert l4["decode"] < 1e-5 and l4["argmax"] == 2
    # the replay rewrites the same positions and gives the same logits;
    # in float32 the reference-style attention rounds nothing, while
    # leaving out 4 of 12 prompt positions moves the logits
    assert l4["replay"] < 1e-5 and l4["bf16_scores"] < 1e-5
    assert l4["drop_span"] > 1e-2
    for name in ("k", "v"):      # the replays rewrite only the fed rows
        assert torch.equal(check_cache[name][:, :, :12],
                           cache[name][:, :2, :12])
    chip_smoke.check_l4(dict(l4, bf16_scores=0.5, drop_span=0.5))
    for bad in (dict(decode=0.5), dict(replay=0.5), dict(drop_span=0.0)):
        with pytest.raises(AssertionError, match="L4"):
            chip_smoke.check_l4({**l4, "bf16_scores": 0.5,
                                 "drop_span": 0.5, **bad})


def test_chip_smoke_bf16_score_attention_rounds_like_the_reference():
    """The planted fault computes the reference's gqa_decode arithmetic:
    equal to the plain version in float32, off it in bfloat16."""
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for s in ((2, 6, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    lengths = torch.tensor([40, 17], dtype=torch.int32)
    want = decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(
        chip_smoke.bf16_score_attention(q, k, v, lengths), want, rtol=1e-5,
        atol=1e-5)
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    got16 = chip_smoke.bf16_score_attention(q16, k16, v16, lengths)
    assert got16.dtype == torch.bfloat16
    assert 0 < chip_smoke.rel_l2(got16, decode_attention_ref(
        q16.float(), k16.float(), v16.float(), lengths)) < 5e-2
    short = chip_smoke.drop_span_attention(8)(q, k, v, lengths)
    torch.testing.assert_close(short, decode_attention_ref(
        q, k[:, 8:], v[:, 8:], lengths - 8))


def test_chip_smoke_segment_bound_counts_kept_rows():
    """vals rows of kept edges once, dst once, the output once; the
    figures of the three shapes chip_smoke times."""
    vals = torch.zeros((6, 4))
    dst = torch.tensor([0, 2, 2, -1, 5, 1], dtype=torch.int32)
    assert chip_smoke.segment_matmul_work(vals, dst, 3) == (
        4 * 4 * 4 + 6 * 4 + 3 * 4 * 4, 4 * 4, 2)
    mb_vals, mb_dst = (torch.from_numpy(x)
                       for x in kernels_bench.segment_inputs())
    assert chip_smoke.segment_matmul_work(mb_vals, mb_dst, 2048)[0] == 9502720
    e, n = 1048576, 65536
    dst = torch.from_numpy(np.random.default_rng(0).integers(
        0, n, e).astype(np.int32))
    for dtype, want in ((torch.float32, 574619648),
                        (torch.bfloat16, 289406976)):
        msgs = torch.empty((e, 128), dtype=dtype, device="meta")
        nbytes, ops, _ = chip_smoke.segment_matmul_work(msgs, dst, n)
        assert (nbytes, ops) == (want, e * 128)
    relax = torch.empty((e, 1), device="meta")
    nbytes, _, _ = chip_smoke.segment_matmul_work(relax, dst, n + 1)
    assert nbytes == 8650756
    bound, by = chip_smoke.bound_ms(574619648, e * 128)
    assert by == "bytes" and abs(bound - 0.17153) < 1e-5


@pytest.mark.parametrize("design", ["sorted", "blocked"])
def test_chip_smoke_summation_bound_catches_a_lost_edge(design):
    rng = np.random.default_rng(8)
    vals = torch.from_numpy(rng.standard_normal((3000, 8)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(-1, 6, 3000).astype(np.int32))
    got = torch.zeros((5, 8)).index_add_(
        0, dst[(dst >= 0) & (dst < 5)].long(), vals[(dst >= 0) & (dst < 5)])
    assert chip_smoke.check_summation_bound("ok", got, vals, dst, 5,
                                            design) < 1e-4
    first = int(((dst >= 0) & (dst < 5)).nonzero()[0])
    lost = got.clone()
    lost[dst[first]] -= vals[first]
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.check_summation_bound("lost", lost, vals, dst, 5, design)


def test_chip_smoke_quantized_features_sum_exactly():
    """Sums of the quantized features come out the same in any order,
    in float32 and after rounding the features to bfloat16."""
    feats = chip_smoke.quantized_features(20000, 4, np.random.default_rng(1),
                                          "cpu")
    assert float(feats.abs().max()) <= 4
    for x in (feats, feats.to(torch.bfloat16).float()):
        assert bool(((x * 64).frac() == 0).all())
        forward = torch.zeros(4)
        for row in x:
            forward += row
        assert torch.equal(forward, x.flip(0).sum(0))
        assert torch.equal(forward, x.double().sum(0).float())


def test_chip_smoke_sequential_plain_adds_in_index_order():
    """The oracle chip_smoke holds segment_matmul against at 1e-6: the
    plain version on the CPU, which adds in index order (bit for bit a
    sequential float32 loop), so the same inputs give the same sums on
    every run."""
    rng = np.random.default_rng(12)
    vals = torch.from_numpy((rng.standard_normal((4000, 16)) * 3).astype(
        np.float32))
    dst = torch.from_numpy(rng.integers(-2, 40, 4000).astype(np.int32))
    got = chip_smoke.sequential_plain(vals, dst, 37)
    keep = ((dst >= 0) & (dst < 37)).numpy()
    want = np.zeros((37, 16), np.float32)
    np.add.at(want, dst.numpy()[keep], vals.numpy()[keep])
    assert got.device == vals.device
    assert torch.equal(got, torch.from_numpy(want))


def test_chip_smoke_kernel_name_keeps_template_arguments():
    assert chip_smoke.kernel_name(
        "void (anonymous namespace)::flash_decode_mma<128>(__nv_bfloat16 "
        "const*, int)") == "flash_decode_mma<128>"
    assert chip_smoke.kernel_name(
        "cudnn::fusion::lean_reduction_kernel<false, false, false>") == \
        "cudnn::fusion::lean_reduction_kernel<false, false, false>"


@pytest.mark.parametrize("draw", ["sweep", "repeated hubs", "big counts"])
def test_chip_smoke_rows_as_index_keeps_the_answers(draw):
    """chip_smoke's index form of gathered rows (the rows written into an
    index whose pad hub lies above every real hub, read back by id)
    answers as the rows do, through the plain version on the CPU."""
    from repro_torch.kernels.spc_query.ref import spc_query_ref
    cpu = torch.device("cpu")
    rows, n = {
        "sweep": (chip_smoke.sweep_rows(33, 16, 50,
                                        np.random.default_rng(2), cpu), 50),
        "repeated hubs": (chip_smoke.repeated_hub_rows(cpu)[0], 10),
        "big counts": (chip_smoke.big_count_rows(cpu)[0], 3)}[draw]
    idx, s, t = chip_smoke.rows_as_index(rows, n)
    assert idx.hub.shape == (idx.n + 1, rows[0].shape[1])
    assert int(idx.hub.max()) == idx.n and bool((idx.hub <= idx.n).all())
    for got, want in zip(chip_smoke.index_plain(idx, s, t),
                         spc_query_ref(*rows)):
        assert torch.equal(got, want)


def test_chip_smoke_index_bound_counts_real_labels_once():
    """The fused kernel's bound reads each queried row's real hubs once
    (plus the pad that ends a row short of L), dist and cnt at the
    common hubs, the ids and the answers."""
    from repro_torch.kernels.spc_query.ops import prep_rows
    n = 40
    svc = DynamicSPC(n, random_graph_edges(n, 90, seed=3), device="cpu")
    rng = np.random.default_rng(5)
    s, t = (torch.from_numpy(rng.integers(0, n, 64)) for _ in range(2))
    rows = prep_rows(svc.index, s, t)
    hub = host(svc.index.hub)
    queried = np.unique(np.concatenate([host(s), host(t)]))
    real = (hub[queried] < n).sum(axis=1)
    hub_bytes = 4 * int((real + (real < hub.shape[1])).sum())
    _, ops, common = chip_smoke.spc_query_work(rows)
    assert chip_smoke.spc_query_index_work(svc.index, s, t, rows) == (
        16 * 64 + hub_bytes + 24 * common + 12 * 64, ops, common)


def test_chip_smoke_sector_bytes_count_the_32_byte_sectors_a_row_spans():
    """72-byte rows (D 18, float32) span 3 sectors of 32 bytes wherever
    they start on 8 bytes; 32-byte rows (D 8) one; ids read from the end
    and past the table land on their rows as the kernel reads them."""
    table18 = torch.zeros((101, 18))
    ids = torch.tensor([[0, 1, 2, 3], [-1, -101, 100, 7]], dtype=torch.int32)
    assert chip_smoke.sector_bytes(ids, table18) == 8 * 3 * 32
    assert chip_smoke.sector_bytes(ids, torch.zeros((101, 8))) == 8 * 32


@pytest.mark.parametrize("n,repeat", [(40, True), (300, True), (300, False)])
def test_chip_smoke_synthetic_index_keeps_real_hubs_below_n(n, repeat):
    """chip_smoke's synthetic indexes are indexes: rows sorted by hub, real
    hubs below the pad hub n (also when hubs repeat and n < 64), pads hub
    n with dist INF and cnt 0, a tenth or so of the rows full."""
    idx = chip_smoke.synthetic_index(n, 64, np.random.default_rng(n), "cpu",
                                     repeat)
    hub, dist, cnt = host(idx.hub), host(idx.dist), host(idx.cnt)
    real = np.arange(64)[None, :] < host(idx.size)[:, None]
    assert (np.diff(hub, axis=1) >= 0).all()
    assert (hub[real] < n).all() and (hub[~real] == n).all()
    assert (dist[~real] == 1 << 28).all() and (cnt[~real] == 0).all()
    assert (host(idx.size)[:n] == 64).any()
