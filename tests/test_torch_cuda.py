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
version on the fp32 copies of the same inputs), zeros at length 0.
spc_query counts every pair of equal hubs where a hub repeats within a
row, and stays exact on padded rows at L = 2048.  The segment_matmul
kernel equals its plain version within rtol = atol = 1e-6 in float32
(1e-2 in bfloat16 against the float32 sum of the same values), exactly
where every order of summation gives the same floats, and two launches
give the same bits; its blocked design equals a sequential float32 loop
bit for bit; the microbench entry point runs.  flash_decode's
tensor-core route (bfloat16, D 64 and 128) equals its plain version
within 1e-2 on groups of 1 to 40 heads with ragged and zero lengths,
and embedding_bag reads ids in [-(V + 1), -1] from the end.  The
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
from repro_torch.bench import kernels_bench as KB
from repro_torch.configs.pna import CONFIG as PNA_CONFIG
from repro_torch.core.bfs import plain_spc_bfs
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import graph_stream, random_graph_edges
from repro_torch.kernels import common
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import segment_matmul as SM
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


def test_kernel_counts_every_pair_of_repeated_hubs(card):
    rows = tuple(torch.from_numpy(x).to(card)
                 for x in KB.query_inputs(1024, 64, seed=0))
    d, c = spc_query_cuda(*rows)
    d_p, c_p = spc_query_ref(*rows)
    assert torch.equal(d, d_p) and torch.equal(c, c_p)
    rows, (want_d, want_c) = chip_smoke.repeated_hub_rows(card)
    d, c = spc_query_cuda(*rows)
    torch.cuda.synchronize()
    assert d.tolist() == want_d and c.tolist() == want_c


@pytest.mark.parametrize("t_pad", ["n", "n + 1"])
def test_kernel_on_padded_rows_with_repeats_at_l_2048(card, t_pad):
    """Rows padded as the index pads them (hub n, dist INF) at L = 2048,
    hubs repeating: a pad run of L(t) as long as the row is never walked,
    and the answer is the L x L table's."""
    b, l_cap, n = 32, 2048, 300
    rng = np.random.default_rng(11)
    out = []
    for pad in (n, n if t_pad == "n" else n + 1):
        hub = np.full((b, l_cap), pad, dtype=np.int32)
        dist = np.full((b, l_cap), 1 << 28, dtype=np.int32)
        cnt = np.zeros((b, l_cap), dtype=np.int64)
        for r in range(b):
            k = int(rng.integers(0, 600))
            hub[r, :k] = np.sort(rng.integers(0, n, k))
            dist[r, :k] = rng.integers(0, 12, k)
            cnt[r, :k] = rng.integers(1, 9, k)
        out += [hub, dist, cnt]
    rows = tuple(torch.from_numpy(x).to(card) for x in out)
    d, c = spc_query_cuda(*rows)
    d_p, c_p = spc_query_ref(*rows)
    assert torch.equal(d, d_p) and torch.equal(c, c_p)
    assert (d < (1 << 28)).any()


@pytest.mark.parametrize("e,n,d", list(chip_smoke.SEG_SWEEP)
                         + [(0, 7, 16), (5000, 40, 1), (3000, 9, 260),
                            (777, 1, 12)])
def test_segment_matmul_kernel_equals_plain_version(card, e, n, d):
    """Float32 within rtol = atol = 1e-6 of the plain version where
    segments are as short as the TPU sweep's (8 edges on average); the
    longer segments of the last three shapes (125 to 777 edges) within
    the error bound of float32 summation of the float64 sum instead,
    where the two summation orders part by more than 1e-6."""
    vals, dst = chip_smoke.segment_sweep_inputs(e, n, d, card)
    for ids in (dst, dst - 5):                     # ids >= n, then < 0
        before = SM.launches.count
        got = SM.segment_matmul_cuda(vals, ids, n)
        again = SM.segment_matmul_cuda(vals, ids, n)
        torch.cuda.synchronize()
        assert SM.launches.count == before + 2
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert torch.equal(got, again)
        if (e, n, d) in chip_smoke.SEG_SWEEP or e == 0:
            torch.testing.assert_close(
                got, chip_smoke.sequential_plain(vals, ids, n), rtol=1e-6,
                atol=1e-6)
        chip_smoke.check_summation_bound(
            "f32", got, vals, ids, n, SM.kernel.plan(e, n, d, vals.dtype))
        vals16 = vals.to(torch.bfloat16)
        got16 = SM.segment_matmul_cuda(vals16, ids, n)
        torch.cuda.synchronize()
        assert got16.dtype == torch.bfloat16
        torch.testing.assert_close(
            got16.float(), SM.segment_matmul_ref(vals16.float(), ids, n),
            rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("aligned", [True, False])
def test_segment_matmul_long_segments_are_exact(card, aligned):
    """Segments far longer than a chunk, ids shuffled, integer values (so
    every order of summation gives the same floats); also through the
    scalar loads of a vals view that is not 16-byte aligned."""
    rng = np.random.default_rng(5)
    ids = np.concatenate([np.full(chip_smoke.SEG_LONG, 3), np.full(700, 0),
                          rng.integers(-2, 12, 2000)])
    dst = torch.from_numpy(rng.permutation(ids).astype(np.int32)).to(card)
    e, d = ids.size, 128
    flat = torch.from_numpy(rng.integers(-8, 9, e * d + 1).astype(
        np.float32)).to(card)
    vals = (flat[:-1] if aligned else flat[1:]).view(e, d)
    for x in (vals, vals.to(torch.bfloat16)):
        got = SM.segment_matmul_cuda(x, dst, 10)
        torch.cuda.synchronize()
        assert torch.equal(got, SM.segment_matmul_ref(x, dst, 10))


def test_segment_matmul_rejects_what_it_does_not_take(card):
    vals, dst = chip_smoke.segment_sweep_inputs(100, 30, 16, card)
    with pytest.raises(ValueError, match="dtype"):
        SM.segment_matmul_cuda(vals, dst.long(), 30)
    with pytest.raises(ValueError, match="dtype"):
        SM.segment_matmul_cuda(vals.half(), dst, 30)
    with pytest.raises(ValueError, match="contiguous"):
        SM.segment_matmul_cuda(vals.t().contiguous().t(), dst, 30)
    with pytest.raises(ValueError, match="shape"):
        SM.segment_matmul_cuda(vals, dst[:50], 30)
    with pytest.raises(ValueError, match="on cpu"):
        SM.segment_matmul_cuda(vals, dst.cpu(), 30)
    assert SM.segment_matmul_cuda(vals, dst, 0).shape == (0, 16)


def test_segment_matmul_ops_launch_on_the_card(card):
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 50, 400))
    dst = torch.from_numpy(rng.integers(-3, 53, 400))          # int64
    dst[:3] = torch.tensor([2 ** 40, -2 ** 40, 2 ** 32 + 1])   # dropped
    before = SM.launches.count
    got = SM.scatter_add(feats[src].to(card), dst.to(card), 50)
    torch.testing.assert_close(got.cpu(), SM.scatter_add(feats[src], dst, 50),
                               rtol=1e-6, atol=1e-6)
    got = SM.gather_scatter(feats.to(card), src.to(card), dst.to(card), 50)
    torch.testing.assert_close(
        got.cpu(), SM.gather_scatter(feats, src, dst, 50), rtol=1e-6,
        atol=1e-6)
    assert SM.launches.count == before + 2


def test_kernels_bench_runs_on_the_card(card):
    q, = KB.query_kernel_vs_plain(256, 64, seed=1)
    s, = KB.segment_matmul_vs_segment_sum(4096, 512, 128, seed=1)
    assert q["device"] == torch.cuda.get_device_name(0)
    assert q["kernel_us_per_q"] > 0 and q["plain_us_per_q"] > 0
    assert s["kernel_ms"] > 0 and s["index_add_ms"] > 0
    assert s["chunks"] == SM.kernel.chunks(4096)


def test_embedding_bag_reads_ids_from_the_end(card):
    """F1 on the card: ids in [-(V + 1), -1] read row V + 1 + id through
    the kernel and the ops, as the reference reads them; ids past the
    table and below -(V + 1) (F2) read the zero row."""
    ids, table, want = chip_smoke.wrapped_id_rows(card)
    before = EB.launches.count
    got = EB.embedding_bag_cuda(ids, table)
    ops = EB.embedding_bag(ids, table[:-1])
    ops_mean = EB.embedding_bag(ids.long(), table[:-1], mode="mean")
    torch.cuda.synchronize()
    assert EB.launches.count == before + 3
    assert got.tolist() == want and ops.tolist() == want
    assert torch.equal(got, EB.embedding_bag_ref(ids, table))
    torch.testing.assert_close(
        ops_mean.cpu(), EB.embedding_bag(ids.long().cpu(), table[:-1].cpu(),
                                         mode="mean"), rtol=0, atol=0)
    rng = np.random.default_rng(21)
    v = 300
    ids, table = chip_smoke.bag_inputs(64, 9, v, 24, rng, card)
    ids = torch.where(ids % 3 == 0, ids - (v + 1), ids)       # from the end
    for x in (table, table.to(torch.bfloat16)):
        torch.testing.assert_close(
            EB.embedding_bag_cuda(ids, x).float(),
            EB.embedding_bag_ref(ids, x.float()), rtol=1e-2 if
            x.dtype == torch.bfloat16 else 1e-6, atol=1e-2 if
            x.dtype == torch.bfloat16 else 1e-6)


def _segment_cases():
    """(e, n, d, ids transform): the sweep with unsorted ids, ids past n
    and negative ids, segments with no edge, and E = 0."""
    return [(e, n, d, shift) for e, n, d in chip_smoke.SEG_SWEEP
            for shift in (0, -5)] + [(0, 7, 16, 0), (16384, 2048, 128, 0),
                                     (3000, 500, 64, -3), (100, 4000, 8, 0)]


@pytest.mark.parametrize("e,n,d,shift", _segment_cases())
def test_segment_matmul_blocked_design_equals_plain_version(card, e, n, d,
                                                            shift):
    """The blocked design sums each segment in id order from zero, one
    add after another: bit for bit the float32 sum of a sequential loop
    (``np.add.at``), so within rtol = atol = 1e-6 of the plain version
    where segments are short and within the error bound of float32
    summation everywhere; bfloat16 the same sums rounded once; two
    launches bitwise equal; one launch a call, and at the microbench
    shape the plan picks it."""
    vals, dst = chip_smoke.segment_sweep_inputs(e, n, d, card)
    ids = dst + shift
    if (e, n, d) == (16384, 2048, 128):
        assert SM.kernel.plan(e, n, d, torch.float32) == "blocked"
    before = SM.launches.count
    got = SM.kernel._blocked_cuda(vals, ids, n)
    again = SM.kernel._blocked_cuda(vals, ids, n)
    torch.cuda.synchronize()
    assert SM.launches.count == before + 2
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert torch.equal(got, again)
    keep = ((ids >= 0) & (ids < n)).cpu().numpy()
    sequential = np.zeros((n, d), np.float32)
    np.add.at(sequential, ids.cpu().numpy()[keep], vals.cpu().numpy()[keep])
    assert torch.equal(got.cpu(), torch.from_numpy(sequential))
    if e <= 2 * n or (e, n, d) in chip_smoke.SEG_SWEEP:
        torch.testing.assert_close(
            got, chip_smoke.sequential_plain(vals, ids, n), rtol=1e-6,
            atol=1e-6)
    chip_smoke.check_summation_bound("blocked", got, vals, ids, n, "blocked")
    vals16 = vals.to(torch.bfloat16)
    got16 = SM.kernel._blocked_cuda(vals16, ids, n)
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16
    sequential16 = np.zeros((n, d), np.float32)
    np.add.at(sequential16, ids.cpu().numpy()[keep],
              vals16.float().cpu().numpy()[keep])
    assert torch.equal(got16.cpu(),
                       torch.from_numpy(sequential16).to(torch.bfloat16))
    torch.testing.assert_close(
        got16.float(), SM.segment_matmul_ref(vals16.float(), ids, n),
        rtol=1e-2, atol=1e-2)


def test_segment_matmul_blocked_design_on_long_segments_is_exact(card):
    """Integer values, so every order of summation gives the same floats:
    a segment of 14329 edges among others, ids shuffled, through aligned
    and unaligned vals and dst."""
    rng = np.random.default_rng(6)
    ids = np.concatenate([np.full(chip_smoke.SEG_LONG, 3), np.full(700, 0),
                          rng.integers(-2, 12, 2000)])
    flat_ids = torch.from_numpy(np.concatenate(
        [[0], rng.permutation(ids)]).astype(np.int32)).to(card)
    e, d = ids.size, 64
    flat = torch.from_numpy(rng.integers(-8, 9, e * d + 1).astype(
        np.float32)).to(card)
    for aligned in (True, False):
        vals = (flat[:-1] if aligned else flat[1:]).view(e, d)
        dst = flat_ids[1:] if not aligned else flat_ids[1:].clone()
        for x in (vals, vals.to(torch.bfloat16)):
            got = SM.kernel._blocked_cuda(x, dst, 10)
            torch.cuda.synchronize()
            assert torch.equal(got, SM.segment_matmul_ref(x, dst, 10))


def test_segment_matmul_blocked_design_refuses_wide_rows(card):
    vals, dst = chip_smoke.segment_sweep_inputs(100, 30, 300, card)
    before = SM.launches.count
    with pytest.raises(ValueError, match="blocked design"):
        SM.kernel._blocked_cuda(vals, dst, 30)
    assert SM.launches.count == before
    assert SM.kernel.plan(100, 30, 300, torch.float32) == "sorted"


#: DECODE_SWEEP shapes the tensor-core route takes (bf16, D 64 or 128),
#: groups of 1, 6 and 12, and two more: 16 heads over 1 KV head (one
#: full M tile) and 40 over 2 (two head chunks of 16 and one of 4 rows).
MMA_SHAPES = [x for x in chip_smoke.DECODE_SWEEP if x[4] in (64, 128)] + [
    (3, 16, 1, 1000, 128), (3, 40, 2, 333, 64), (17, 6, 1, 4160, 128)]


@pytest.mark.parametrize("b,h,kvh,s,d", MMA_SHAPES)
def test_flash_decode_mma_route_equals_plain_version(card, b, h, kvh, s, d):
    """bfloat16 at D 64 and 128 runs on the tensor cores: within 1e-2 of
    the plain version on the fp32 copies of the same inputs (and of the
    CUDA-core route), ragged lengths, length 0 giving zeros, lengths
    past S clamped, and two launches bitwise equal."""
    rng = np.random.default_rng(b * s + h)
    q, k, v, lengths = chip_smoke.decode_inputs(b, h, kvh, s, d, rng, card)
    if b > 3:
        lengths[0] = s + 7                     # past the cache: all of it
        lengths[1] = 63                        # inside the first tile
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    assert FD.plan(b, kvh, h, s, d, torch.bfloat16,
                   torch.cuda.get_device_properties(0)
                   .multi_processor_count).route == "mma"
    before = FD.launches.count
    got = FD.flash_decode_cuda(q16, k16, v16, lengths)
    again = FD.flash_decode_cuda(q16, k16, v16, lengths)
    simt = FD.kernel._simt_cuda(q16, k16, v16, lengths)
    torch.cuda.synchronize()
    assert FD.launches.count == before + 3
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, d)
    assert torch.equal(got, again)
    want = FD.decode_attention_ref(q16.float(), k16.float(), v16.float(),
                                   lengths)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), simt.float(), rtol=1e-2,
                               atol=1e-2)
    if b > 2:
        assert not got[-1].any()               # length 0: zeros
