"""The port's first slice end to end, and its boundaries.

* build -> maintain -> serve at the ``dspc`` SMOKE configuration in both
  packages: identical state after the build and after every event chunk,
  identical answers on every route;
* the port (and ``chip_smoke.py``) imports neither JAX nor ``repro``;
* ``chip_smoke.py`` refuses to run without a card, or without the
  repository beside it, and prints no result then;
* the port's copies of the configuration and the data generators agree
  with the reference's."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.dspc import CONFIG as JAX_CONFIG
from repro.configs.dspc import SMOKE as JAX_SMOKE
from repro.core.dynamic import DynamicSPC as JaxDSPC
from repro.data import graph_stream as jax_graph_stream
from repro.data import random_graph_edges as jax_random_graph_edges
from repro.serve import QueryEngine as JaxEngine
from repro_torch.configs.dspc import CONFIG, SMOKE
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels import common
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
        print("IMPORTED", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20


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


def test_kernel_build_is_lazy_and_keyed_by_source(monkeypatch):
    path = common.library_path("spc_query")
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("libspc_query-") and path.suffix == ".so"
    assert "spc_query" not in common._loaded  # nothing built at import
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(REPO))  # no bin/nvcc there
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common._nvcc()
