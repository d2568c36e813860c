"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They import no JAX, so they run on a machine with the card and PyTorch
alone: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Elsewhere each one skips with its reason.  The CUDA kernel must equal
its plain PyTorch version exactly (integer outputs), count its
launches, and carry the main path: a small build -> events -> serve on
the card answers as the counting BFS does, through the kernel route.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels.spc_query import launches, spc_query_cuda
from repro_torch.kernels.spc_query.ref import spc_query_ref
from repro_torch.serve import QueryEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc (the kernel is "
                    "built from src/repro_torch/csrc at its first call)")
    return torch.device("cuda")


@pytest.mark.parametrize("b,l_cap", [(4, 8), (130, 16), (256, 32),
                                     (17, 128), (1024, 64)])
def test_kernel_equals_plain_version(card, b, l_cap):
    rng = np.random.default_rng(b * l_cap)
    rows = chip_smoke.sweep_rows(b, l_cap, max(50, 2 * l_cap), rng, card)
    before = launches.count
    d, c = spc_query_cuda(*rows)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    d_p, c_p = spc_query_ref(*rows)
    assert torch.equal(d, d_p) and torch.equal(c, c_p)


def test_kernel_counts_beyond_fp32_and_int32(card):
    rows, (want_d, want_c) = chip_smoke.big_count_rows(card)
    d, c = spc_query_cuda(*rows)
    torch.cuda.synchronize()
    assert d.tolist() == want_d and c.tolist() == want_c


def test_kernel_rejects_what_it_does_not_take(card):
    rows = chip_smoke.sweep_rows(8, 16, 50, np.random.default_rng(0), card)
    with pytest.raises(ValueError, match="dtype"):
        spc_query_cuda(*rows[:2], rows[2].to(torch.float32), *rows[3:])
    with pytest.raises(ValueError, match="contiguous"):
        spc_query_cuda(rows[0].t().contiguous().t(), *rows[1:])
    with pytest.raises(ValueError, match="shape"):
        spc_query_cuda(rows[0][:4], *rows[1:])


def test_main_path_on_the_card(card):
    n = 96
    edges = random_graph_edges(n, 300, seed=7)
    svc = DynamicSPC(n, edges, l_cap=None, construct_batch=8)
    assert svc.index.hub.is_cuda
    svc.apply_events(graph_stream(edges, n, 8, 8, seed=8), batch_size=16)
    eng = QueryEngine()
    before = launches.count
    for s in range(0, n, 7):
        res = plain_spc_bfs(svc.graph, s)
        d, c = eng.query_batch(svc.index, np.full(n, s), np.arange(n))
        assert torch.equal(d, res.dist[:n]) and torch.equal(c, res.cnt[:n])
    assert dict(eng.stats.routes) == {"kernel": len(range(0, n, 7))}
    assert launches.count > before
