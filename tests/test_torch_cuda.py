"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They import no JAX, so they run on a machine with the card and PyTorch
alone: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Elsewhere each one skips with its reason.  The spc_query kernel must
equal its plain PyTorch version exactly (integer outputs), the
embedding_bag kernel within rtol = atol = 1e-6 in float32 (1e-2 in
bfloat16); each counts its launches and rejects what it does not take,
and a kernel that cannot be loaded raises instead of answering with the
plain version.  The flash_decode kernel equals its plain version within
rtol = atol = 2e-5 in float32 and 1e-2 in bfloat16 (against the plain
version on the fp32 copies of the same inputs), zeros at length 0.  The
main paths run on the card: a small build -> events -> serve answers as
the counting BFS does through the kernel route, the analytics path
(store, betweenness, cycles, recommendation -> PNA re-rank) gives the
CPU's answers, and the LM path at qwen2-1.5b ``SMOKE`` (prefill, then
decode through the kernel) gives the CPU's logits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.analytics import AnalyticsEngine
from repro_torch.configs.pna import CONFIG as PNA_CONFIG
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels import common
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels.spc_query import launches, spc_query_cuda
from repro_torch.kernels.spc_query.ref import spc_query_ref
from repro_torch.models import transformer as tf
from repro_torch.models.gnn.pna import PNA
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


@pytest.mark.parametrize("b,s,v,d", list(chip_smoke.BAG_SWEEP)
                         + [(300, 8, 100_000, 18), (33, 40, 500, 8),
                            (5, 0, 10, 8), (64, 3, 50, 70)])
def test_embedding_bag_kernel_equals_plain_version(card, b, s, v, d):
    ids, table = chip_smoke.bag_inputs(b, s, v, d,
                                       np.random.default_rng(b + d), card)
    ids[0, :min(s, 2)] = v + 3                     # past the table: zero row
    if s > 2:
        ids[-1, 2] = -5
    before = EB.launches.count
    got = EB.embedding_bag_cuda(ids, table)
    torch.cuda.synchronize()
    assert EB.launches.count == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, d)
    torch.testing.assert_close(got, EB.embedding_bag_ref(ids, table),
                               rtol=1e-6, atol=1e-6)
    table16 = table.to(torch.bfloat16)
    got16 = EB.embedding_bag_cuda(ids, table16)
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(),
                               EB.embedding_bag_ref(ids, table16.float()),
                               rtol=1e-2, atol=1e-2)


def test_embedding_bag_kernel_rejects_what_it_does_not_take(card):
    ids, table = chip_smoke.bag_inputs(8, 4, 30, 16,
                                       np.random.default_rng(0), card)
    with pytest.raises(ValueError, match="dtype"):
        EB.embedding_bag_cuda(ids.long(), table)
    with pytest.raises(ValueError, match="dtype"):
        EB.embedding_bag_cuda(ids, table.half())
    with pytest.raises(ValueError, match="contiguous"):
        EB.embedding_bag_cuda(ids.t().contiguous().t(), table)
    with pytest.raises(ValueError, match="shape"):
        EB.embedding_bag_cuda(ids[0], table)
    with pytest.raises(ValueError, match="on cpu"):
        EB.embedding_bag_cuda(ids, table.cpu())


def test_embedding_bag_ops_launch_on_the_card(card):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 41, (16, 5)))   # int64, 40 = pad
    before = EB.launches.count
    for mode in ("sum", "mean"):
        got = EB.embedding_bag(ids.to(card), table.to(card), mode=mode,
                               pad_id=40)
        torch.testing.assert_close(
            got.cpu(), EB.embedding_bag(ids, table, mode=mode, pad_id=40),
            rtol=1e-6, atol=1e-6)
    assert EB.launches.count == before + 2


def test_embedding_bag_raises_when_the_kernel_cannot_load(card, monkeypatch):
    def broken(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(common, "load", broken)
    ids, table = chip_smoke.bag_inputs(4, 3, 16, 8,
                                       np.random.default_rng(1), card)
    before = EB.launches.count
    with pytest.raises(RuntimeError, match="cannot load embedding_bag"):
        EB.embedding_bag(ids, table[:16])
    assert EB.launches.count == before


def test_analytics_path_on_the_card(card):
    n = 150
    edges = chip_smoke.power_law_edges(n, 500, 1)
    results = {}
    for dev in ("cuda", "cpu"):
        svc = DynamicSPC(n, edges, device=dev, construct_batch=8)
        eng = AnalyticsEngine(svc.attach_store(), pair_sample=60, top_k=6)
        pairs = eng.sample_pairs()
        maint = eng.betweenness_maintainer(pairs)
        svc.apply_events(graph_stream(edges, n, 4, 4, seed=2), batch_size=8)
        maint.refresh()
        view = eng.pin()
        hot = maint.top(1)[0][0]
        u = int(view.index.size[:n].argmax())
        recs = view.recommend(u)
        pna = PNA(dataclasses.replace(PNA_CONFIG, d_in=4),
                  generator=torch.Generator().manual_seed(0), device=dev)
        table = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (n, 8)).astype(np.float32)).to(dev)
        before = EB.launches.count
        _, model, _ = chip_smoke.rerank(view, u, recs, pna, table)
        results[dev] = (maint.scores(), maint.last_changed,
                        view.cycles_through_vertex(hot), recs, model,
                        EB.launches.count - before)
    got, want = results["cuda"], results["cpu"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    assert got[1:4] == want[1:4]
    np.testing.assert_allclose(got[4], want[4], rtol=1e-4, atol=1e-5)
    assert got[5] == 1 and want[5] == 0


@pytest.mark.parametrize("b,h,kvh,s,d", list(chip_smoke.DECODE_SWEEP)
                         + [(5, 16, 2, 4100, 128), (3, 6, 3, 65, 16),
                            (1, 12, 2, 1, 32)])
def test_flash_decode_kernel_equals_plain_version(card, b, h, kvh, s, d):
    q, k, v, lengths = chip_smoke.decode_inputs(
        b, h, kvh, s, d, np.random.default_rng(b * s + d), card)
    before = FD.launches.count
    got = FD.flash_decode_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    assert FD.launches.count == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    torch.testing.assert_close(got, FD.decode_attention_ref(q, k, v, lengths),
                               rtol=2e-5, atol=2e-5)
    if b > 2:
        assert not got[-1].any()                   # length 0: zeros
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    got16 = FD.flash_decode_cuda(q16, k16, v16, lengths)
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(
        got16.float(), FD.decode_attention_ref(q16.float(), k16.float(),
                                               v16.float(), lengths),
        rtol=1e-2, atol=1e-2)


def test_flash_decode_kernel_rejects_what_it_does_not_take(card):
    q, k, v, lengths = chip_smoke.decode_inputs(
        2, 4, 2, 64, 32, np.random.default_rng(0), card)
    with pytest.raises(ValueError, match="dtypes"):
        FD.flash_decode_cuda(q.half(), k, v, lengths)
    with pytest.raises(ValueError, match="dtype"):
        FD.flash_decode_cuda(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        FD.flash_decode_cuda(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v, lengths)
    with pytest.raises(ValueError, match="head dim"):
        FD.flash_decode_cuda(q[..., :24].contiguous(),
                             k[..., :24].contiguous(),
                             v[..., :24].contiguous(), lengths)
    with pytest.raises(ValueError, match="do not divide"):
        FD.flash_decode_cuda(q[:, :3].contiguous(), k, v, lengths)
    with pytest.raises(ValueError, match="on cpu"):
        FD.flash_decode_cuda(q, k.cpu(), v, lengths)


def test_flash_decode_ops_launch_on_the_card(card):
    q, k, v, lengths = chip_smoke.decode_inputs(
        3, 6, 2, 300, 64, np.random.default_rng(2), card)
    before = FD.launches.count
    got = FD.decode_attention(q, k, v, lengths.long())
    assert FD.launches.count == before + 1
    torch.testing.assert_close(
        got.cpu(), FD.decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                       lengths.cpu()), rtol=2e-5, atol=2e-5)


def test_flash_decode_raises_when_the_kernel_cannot_load(card, monkeypatch):
    def broken(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(common, "load", broken)
    q, k, v, lengths = chip_smoke.decode_inputs(
        2, 4, 2, 64, 32, np.random.default_rng(1), card)
    before = FD.launches.count
    with pytest.raises(RuntimeError, match="cannot load flash_decode"):
        FD.decode_attention(q, k, v, lengths)
    assert FD.launches.count == before


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_lm_path_on_the_card(card):
    """qwen2-1.5b SMOKE in float32: prefill (plain and blockwise) and
    greedy decode on the card give the CPU's logits, and every decode
    step of every layer launches the kernel once."""
    from repro_torch.configs.qwen2_1_5b import SMOKE as QWEN_SMOKE
    cfg = dataclasses.replace(QWEN_SMOKE, param_dtype=torch.float32,
                              act_dtype=torch.float32,
                              blockwise_prefill_from=32, prefill_block_k=16)
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (3, 40)).astype(np.int32))
    results = {}
    for dev in ("cpu", "cuda"):
        p = tf.load_reference_params(numpy_tree(params), device=dev)
        for t in (20, 40):                         # plain, then blockwise
            logits, cache = chip_smoke.prefill_in_groups(
                p, cfg, prompts[:, :t].to(dev), t + 6, 2)
            before = FD.launches.count
            fed, last, cache, _ = chip_smoke.greedy_decode(
                p, cfg, cache, logits.argmax(-1).to(torch.int32), 6)
            results[dev, t] = (logits.cpu(), fed.cpu(), last.cpu(),
                               FD.launches.count - before)
    for t in (20, 40):
        cpu, gpu = results["cpu", t], results["cuda", t]
        torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4, atol=1e-4)
        assert torch.equal(gpu[1], cpu[1])
        torch.testing.assert_close(gpu[2], cpu[2], rtol=1e-4, atol=1e-4)
        assert cpu[3] == 0 and gpu[3] == cfg.n_layers * 6
