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
decode through the kernel) gives the CPU's logits, as do the MLA + MoE
``SMOKE`` configurations (deepseek-v2-lite-16b, deepseek-v2-236b), and
flash_decode holds at the LM family's groups of 7, 4 and 5 heads; the
GNN family (EGNN, NequIP, Equiformer-v2 at ``SMOKE``) gives the CPU's
outputs on a molecule batch and a sampled block, launching no kernel;
DIEN at ``SMOKE`` (forward, retrieval, loss and gradients) and a
qwen2-1.5b ``SMOKE`` AdamW step give the CPU's numbers.
spc_query's fused
kernel reads rows by vertex id: it equals its plain version on a built
index padded to L = 2048 at B 1, 7, 1024 and 4096 (ids outside [0, n]
among them), on long rows whose hubs repeat, at L 16000 (64000 bytes of
staged row) and 16400 (searched in device memory), rejects what it does
not take, and the op and the engine launch it once per batch with no [B, L]
gather.  embedding_bag's packed design equals its plain version at D 8,
18, 32 and 130 in float32 and bfloat16 with F1's ids, equals the warp
design bit for bit, and two launches give the same bits.  The service
stack runs on the card: an ``SPCService`` (updater thread, readers of
every consistency level, a checkpoint restart) and its front door
(concurrent callers, coalesced into kernel launches) answer as the same
stack on the CPU, a replica pulling from the card's directory stages
onto the card, and 8 threads launching K1 at once count every launch.
Distributed DSPC runs on the card: a mesh of four ``cuda:0`` entries
builds, applies events and serves (a mesh-staged store, the sharded
route, an ``SPCService`` with both meshes) exactly as the single-device
engine does; a mesh that mixes the card with the CPU places edge
shards, index copies and query shards on both devices with the same
answers; and, on a machine with several cards, a mesh of every card
does the same through NCCL's reduce and broadcast.  The mesh models
run on the card: flash_decode's LSE output on both routes is within
1e-4 of its plain version (``-inf`` at length 0, the outputs bit for bit
those of the call without it), the sequence-sharded decode over four
``cuda:0`` entries gives the CPU mesh's logits and cache within 1e-4
with one K4 launch a layer, step and shard, and the ring-partitioned
Equiformer-v2 gives the CPU's node irreps within rtol 1e-4 / atol 1e-5.
"""

import dataclasses
import functools

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
from repro_torch.kernels.embedding_bag.kernel import (
    _warp_cuda as bag_warp_cuda)
from repro_torch.core.labels import repad
from repro_torch.kernels.spc_query import (exact_query_batch, launches, plan,
                                           prep_rows, spc_query_cuda,
                                           spc_query_index_cuda)
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


@pytest.mark.parametrize("arch", ["egnn", "nequip", "equiformer-v2"])
def test_gnn_family_on_the_card_equals_the_cpu(card, arch):
    """EGNN, NequIP and Equiformer-v2 at ``SMOKE`` width in float32:
    ``forward`` on a molecule batch and ``node_forward`` on a sampled
    block (placed on the card by ``NeighborSampler.sample``) give the
    CPU's outputs within rtol 1e-4 / atol 1e-5, launching no kernel of
    the port; the block on the card is the CPU's."""
    import importlib
    from repro_torch.data import molecule_batch
    from repro_torch.models.gnn import sampler as SA
    from repro_torch.models.gnn.graph import from_numpy
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    mol = molecule_batch(0, 6, 10, 20, mod.SMOKE.d_in, seed=1)
    csr = SA.synthetic_csr(400, 6, mod.SMOKE.d_in, 5, seed=2)
    sampler = SA.NeighborSampler(csr, 8, (3, 2), seed=3)
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(sampler.node_cap, 3)).astype(np.float32)
    counters = (launches, SM.launches, EB.launches, FD.launches)
    out, blocks = {}, {}
    for dev in ("cpu", "cuda"):
        model = chip_smoke.gnn_model(arch, mod.SMOKE.d_in, 1, 5, dev) if \
            dev == "cpu" else chip_smoke.gnn_cast(model, torch.float32, dev)
        batch = from_numpy(mol["node_feat"], mol["senders"], mol["receivers"],
                           pos=mol["pos"], graph_id=mol["graph_id"],
                           n_graph=mol["n_graph"], device=dev)
        block = chip_smoke.with_positions(sampler.sample(0, device=dev)[0],
                                          pos)
        before = [c.count for c in counters]
        with torch.inference_mode():
            out[dev] = (model(batch)[0].cpu(),
                        model.node_forward(block)[:8].cpu())
        assert [c.count for c in counters] == before
        blocks[dev] = block
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for name in ("nodes", "senders", "receivers", "pos", "graph_id"):
        assert torch.equal(getattr(blocks["cuda"], name).cpu(),
                           getattr(blocks["cpu"], name)), name


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "deepseek_v2_236b"])
def test_mla_moe_path_on_the_card(card, arch):
    """The MLA + MoE ``SMOKE`` configurations in float32: prefill (plain
    and blockwise at a ragged t) and greedy decode on the card give the
    CPU's logits and tokens (the MoE routing, its drops at the default
    capacity factor included), the cache on the card being ``ckv`` and
    ``kr``; no flash_decode launch (MLA decode is the reference's
    absorbed einsums)."""
    import importlib
    smoke = importlib.import_module(f"repro_torch.configs.{arch}").SMOKE
    cfg = dataclasses.replace(smoke, param_dtype=torch.float32,
                              act_dtype=torch.float32,
                              blockwise_prefill_from=32, prefill_block_k=16)
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 40)).astype(np.int32))
    results = {}
    for dev in ("cpu", "cuda"):
        p = tf.load_reference_params(numpy_tree(params), device=dev)
        assert p["layers"]["ffn"]["router"].dtype == torch.float32
        for t in (20, 37):                       # plain, then blockwise
            logits, cache = chip_smoke.prefill_in_groups(
                p, cfg, prompts[:, :t].to(dev), t + 6, 2)
            assert set(cache) == {"ckv", "kr", "lengths"}
            before = FD.launches.count
            fed, last, cache, _ = chip_smoke.greedy_decode(
                p, cfg, cache, logits.argmax(-1).to(torch.int32), 6)
            results[dev, t] = (logits.cpu(), fed.cpu(), last.cpu(),
                               cache["ckv"].cpu(),
                               FD.launches.count - before)
    for t in (20, 37):
        cpu, gpu = results["cpu", t], results["cuda", t]
        torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4, atol=1e-4)
        assert torch.equal(gpu[1], cpu[1])
        torch.testing.assert_close(gpu[2], cpu[2], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(gpu[3], cpu[3], rtol=1e-4, atol=1e-4)
        assert cpu[4] == gpu[4] == 0


#: The LM family's decode groups: qwen2-7b (28 q / 4 KV heads, 7),
#: phi3-medium-14b at tp 1 (40 / 10, 4) and at the reference's tp 16
#: (48 padded heads, q padded to 10 x 5 = 50 / 10, 5).
FAMILY_GROUPS = [(4, 28, 4, 1500, 128), (4, 40, 10, 1500, 128),
                 (4, 50, 10, 1500, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,s,d", FAMILY_GROUPS)
def test_flash_decode_at_the_lm_family_groups(card, b, h, kvh, s, d, dtype):
    """Groups of 7, 4 and 5 heads: float32 within 2e-5 of the plain
    version (the CUDA-core route), bfloat16 within 1e-2 of it on the fp32
    copies of the same inputs (the tensor-core route), ragged lengths and
    a row of length 0."""
    rng = np.random.default_rng(h * kvh)
    q, k, v, lengths = chip_smoke.decode_inputs(b, h, kvh, s, d, rng, card)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = FD.launches.count
    got = FD.flash_decode_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    assert FD.launches.count == before + 1
    want = FD.decode_attention_ref(q.float(), k.float(), v.float(), lengths)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert not got[-1].any()


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


@functools.lru_cache(maxsize=None)
def built_index_2048():
    """A built index (n 400, power law) padded to L = 2048, as the dspc
    configuration's index is at full scale."""
    n = 400
    svc = DynamicSPC(n, random_graph_edges(n, 1600, seed=5), l_cap=None,
                     construct_batch=8)
    return repad(svc.index, 2048)


@pytest.mark.parametrize("b", [1, 7, 1024, 4096])
def test_fused_kernel_equals_plain_version_on_a_built_index(card, b):
    idx = built_index_2048()
    s, t = chip_smoke.index_ids(idx.n, b, np.random.default_rng(b), card)
    before = launches.count
    d, c = spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, s, t)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert d.dtype == torch.int32 and c.dtype == torch.int64
    d_p, c_p = chip_smoke.index_plain(idx, s, t)
    assert torch.equal(d, d_p) and torch.equal(c, c_p)
    if b >= 1024:
        assert (d < (1 << 28)).any()


@pytest.mark.parametrize("repeat", [False, True])
def test_fused_kernel_on_long_rows_that_repeat_hubs(card, repeat):
    """Rows of every length up to L = 2048 (a tenth full), hubs distinct
    or drawn with replacement from 64: every pair of equal hubs counts,
    in the index form and in the gathered form of the same pairs."""
    rng = np.random.default_rng(12)
    idx = chip_smoke.synthetic_index(2048, 2048, rng, card, repeat)
    s, t = chip_smoke.index_ids(idx.n, 1024, rng, card)
    d, c = spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, s, t)
    rows = tuple(r.contiguous() for r in prep_rows(idx, s, t))
    d_g, c_g = spc_query_cuda(*rows)
    d_p, c_p = spc_query_ref(*rows)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(c, c_p)
    assert torch.equal(d_g, d_p) and torch.equal(c_g, c_p)


@pytest.mark.parametrize("l_cap,design", [(16000, "staged"),
                                          (16400, "global")])
def test_fused_kernel_past_48_kb_of_staging_and_past_its_limit(card, l_cap,
                                                               design):
    """Rows of 16000 labels stage 64000 bytes of shared memory a CTA, past
    the 48 KB a launch gets without asking; rows of 16400 pass the staging
    limit and are searched in device memory."""
    assert plan(l_cap) == design
    rng = np.random.default_rng(l_cap)
    idx = chip_smoke.synthetic_index(40, l_cap, rng, card, repeat=True)
    s, t = chip_smoke.index_ids(idx.n, 8, rng, card)
    d, c = spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, s, t)
    d_p, c_p = chip_smoke.index_plain(idx, s, t)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(c, c_p)


def test_index_kernel_rejects_what_it_does_not_take(card):
    rng = np.random.default_rng(0)
    idx = chip_smoke.synthetic_index(64, 32, rng, card)
    s, t = chip_smoke.index_ids(idx.n, 16, rng, card)
    hub, dist, cnt = idx.hub, idx.dist, idx.cnt
    with pytest.raises(ValueError, match="dtype"):
        spc_query_index_cuda(hub, dist, cnt, s.int(), t)
    with pytest.raises(ValueError, match="dtype"):
        spc_query_index_cuda(hub, dist, cnt.float(), s, t)
    with pytest.raises(ValueError, match="on cpu"):
        spc_query_index_cuda(hub, dist, cnt, s.cpu(), t)
    with pytest.raises(ValueError, match="CUDA"):
        spc_query_index_cuda(hub.cpu(), dist.cpu(), cnt.cpu(), s.cpu(),
                             t.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        spc_query_index_cuda(hub, dist, cnt, s[::2], t[::2])
    with pytest.raises(ValueError, match="contiguous"):
        spc_query_index_cuda(hub.t().contiguous().t(), dist, cnt, s, t)
    with pytest.raises(ValueError, match="shape"):
        spc_query_index_cuda(hub, dist, cnt, s, t[:4])


def test_exact_query_batch_is_one_launch_and_no_gather(card, monkeypatch):
    """On the card the op and the engine launch the fused kernel once per
    batch and gather no [B, L] operand: the gather is made to raise, and
    the peak memory stays below one such operand."""
    import repro_torch.kernels.spc_query.ops as ops
    idx = built_index_2048()
    rng = np.random.default_rng(3)
    s, t = chip_smoke.index_ids(idx.n, 4096, rng, card)
    want = chip_smoke.index_plain(idx, s, t)

    def no_gather(*args):
        raise AssertionError("a [B, L] gather on the card")
    monkeypatch.setattr(ops, "gather_rows", no_gather)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launches.count
    got = exact_query_batch(idx, s, t)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert torch.cuda.max_memory_allocated() - base < 4096 * 2048 * 4
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    eng = QueryEngine()
    s_ok, t_ok = (rng.integers(0, idx.n, 1000) for _ in range(2))
    before = launches.count
    d, c = eng.query_batch(idx, s_ok, t_ok)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert dict(eng.stats.routes) == {"kernel": 1}
    monkeypatch.undo()
    d_p, c_p = chip_smoke.index_plain(idx, torch.from_numpy(s_ok).to(card),
                                      torch.from_numpy(t_ok).to(card))
    assert torch.equal(d, d_p) and torch.equal(c, c_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 18, 32, 130])
def test_packed_embedding_bag_equals_plain_version(card, d, dtype):
    """The packed design at D 8, 18, 32 and 130 with F1's ids (from the
    end, past the table, below -(V + 1)): within 1e-6 of the plain
    version in float32 (1e-2 in bfloat16, against the float32 sum of the
    same bfloat16 rows), and equal to the warp design bit for
    bit."""
    v = 1000
    ids, table = chip_smoke.bag_inputs(300, 9, v, d,
                                       np.random.default_rng(d), card)
    ids[::3, 0] -= v + 1                       # [-(V + 1), -2]: from the end
    ids[1::5, 1] = v + 7                       # past the table: zero row
    ids[2::7, 2] = -(v + 1) - 5                # below -(V + 1): zero row
    x = table.to(dtype)
    before = EB.launches.count
    got = EB.embedding_bag_cuda(ids, x)
    old = bag_warp_cuda(ids, x)
    torch.cuda.synchronize()
    assert EB.launches.count == before + 2
    assert got.dtype == dtype and got.shape == (300, d)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(),
                               EB.embedding_bag_ref(ids, x.float()),
                               rtol=tol, atol=tol)
    assert torch.equal(got, old)


def test_packed_embedding_bag_launches_are_bitwise_equal(card):
    ids, table = chip_smoke.bag_inputs(4096, 8, 100_000, 18,
                                       np.random.default_rng(9), card)
    for x in (table, table.to(torch.bfloat16)):
        a = EB.embedding_bag_cuda(ids, x)
        b = EB.embedding_bag_cuda(ids, x)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _service_pair(tmp_path, device):
    from repro_torch.configs.dspc import SMOKE
    from repro_torch.serve import SPCService
    edges = random_graph_edges(SMOKE.n, SMOKE.m, seed=3)
    return SPCService.from_config(
        SMOKE, edges=edges, device=device, transport="dir",
        publish_dir=str(tmp_path / device), async_checkpoint=True,
        wait_timeout=60.0)


def test_service_on_the_card_equals_the_cpu(card, tmp_path):
    from repro_torch.core.graph import edge_set
    from repro_torch.serve import SPCService
    gpu, cpu = _service_pair(tmp_path, "cuda"), _service_pair(tmp_path, "cpu")
    events = graph_stream(sorted(edge_set(cpu.spc.graph)), cpu.n, 6, 4,
                          seed=4)
    rng = np.random.default_rng(0)
    with gpu, cpu:
        sg, sc = gpu.session(), cpu.session()
        for lo in range(0, len(events), 5):
            sg.submit(events[lo:lo + 5])
            sc.submit(events[lo:lo + 5])
            s, t = rng.integers(0, cpu.n, 300), rng.integers(0, cpu.n, 300)
            for a, b in zip(sg.reader()(s, t), sc.reader()(s, t)):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), b)
        gpu.drain()
        cpu.drain()
        want, got = cpu.state_dict(), gpu.state_dict()
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
        routes = gpu.stats()["serve"][0].routes
        assert set(routes) == {"kernel"}
        from repro_torch.train import checkpoint as C
        C.save(str(tmp_path / "state"), 0, got)
        restored = SPCService.from_checkpoint(str(tmp_path / "state"),
                                              gpu.n)
        assert restored.spc.index.hub.device.type == "cuda"
        s, t = rng.integers(0, cpu.n, 64), rng.integers(0, cpu.n, 64)
        for a, b in zip(restored.query_batch(s, t), cpu.query_batch(s, t)):
            assert torch.equal(a.cpu(), b)
        replica = SPCService(role="replica",
                             publish_dir=str(tmp_path / "cuda"),
                             poll_interval_s=0.01)
        with replica:
            idx = replica.store.current().index
            assert idx.hub.device.type == "cuda"
            assert replica.version == gpu.version
            for a, b in zip(replica.query_batch(s, t), cpu.query_batch(s, t)):
                assert torch.equal(a.cpu(), b)


def test_front_door_on_the_card_equals_the_cpu(card, tmp_path):
    import threading
    gpu, cpu = _service_pair(tmp_path, "cuda"), _service_pair(tmp_path, "cpu")
    with gpu, cpu:
        before = launches.count
        with gpu.frontdoor(dispatchers=2, max_batch=64) as door:
            errors, got = [], {}

            def caller(i):
                rng = np.random.default_rng(i)
                sess = door.session()
                try:
                    for _ in range(64):
                        a, b = (int(x) for x in rng.integers(0, cpu.n, 2))
                        got[(i, a, b)] = sess.query(a, b)
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not errors and not any(th.is_alive() for th in threads)
            st = door.stats()
        assert st["mean_fill"] > 1
        assert launches.count - before == st["batches"]
        keys = sorted(got)
        d, c = cpu.query_batch([k[1] for k in keys], [k[2] for k in keys])
        assert [got[k] for k in keys] == list(zip(d.tolist(), c.tolist()))


def test_threaded_launches_count_exactly(card):
    import threading
    idx = DynamicSPC(64, random_graph_edges(64, 160, seed=1),
                     device="cuda").index
    s = torch.arange(64, device="cuda", dtype=torch.int64)
    before = launches.count

    def worker():
        for _ in range(50):
            spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, s, s.flip(0))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    torch.cuda.synchronize()
    assert launches.count - before == 8 * 50


def _card_mesh_case(devices):
    from repro_torch.launch.mesh import make_mesh
    n = 96
    edges = random_graph_edges(n, 300, seed=7)
    events = graph_stream(edges, n, 8, 8, seed=8)
    mesh = make_mesh((len(devices),), ("model",), devices)
    sharded = DynamicSPC(n, edges, l_cap=None, construct_batch=8, mesh=mesh)
    single = DynamicSPC(n, edges, l_cap=None, construct_batch=8)
    for tag in ("build", "events"):
        want, got = single.state_dict(), sharded.state_dict()
        assert all(got[k].tobytes() == want[k].tobytes() for k in want), tag
        if tag == "build":
            sharded.apply_events(events, batch_size=16)
            single.apply_events(events, batch_size=16)
    return n, sharded, single


@pytest.mark.parametrize("devices", [["cuda:0"] * 4,
                                     ["cuda:0", "cpu", "cuda:0", "cpu"],
                                     "every card"])
def test_sharded_build_and_serve_on_the_card(card, devices):
    from repro_torch.core.distributed import (make_distributed_updater,
                                              replicas_of)
    from repro_torch.core.graph import edge_set
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import SnapshotStore, SPCService
    if devices == "every card":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more cards (NCCL reduce and "
                        "broadcast across distinct cards)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n, sharded, single = _card_mesh_case(devices)
    relax = make_distributed_updater(sharded._updater.mesh,
                                     "model").multi_relax_fn
    assert relax.placements >= 1 and relax.reductions > relax.placements
    serve_mesh = make_mesh((len(devices),), ("data",), devices)
    store = SnapshotStore(sharded.index, mesh=serve_mesh)
    copies = replicas_of(store.current().index)
    assert sorted(str(d) for d in copies) == sorted(
        str(d) for d in serve_mesh.distinct_devices)
    eng = QueryEngine()
    serve = eng.serve_from(store, mesh=serve_mesh)
    rng = np.random.default_rng(1)
    for b in (1, 13, 1024):
        s, t = rng.integers(0, n, b), rng.integers(0, n, b)
        d, c = serve(s, t)
        d0, c0 = QueryEngine().query_batch(single.index, s, t)
        assert d.is_cuda and torch.equal(d, d0) and torch.equal(c, c0)
    assert dict(eng.stats.routes) == {"sharded[data]:merge": 3}
    with SPCService(spc=sharded, serve_mesh=serve_mesh, route="sharded",
                    wait_timeout=60.0) as svc:
        sess = svc.session()
        a, b = next((a, b) for a in range(n) for b in range(a + 1, n)
                    if (a, b) not in edge_set(sharded.graph))
        sess.submit([("+", a, b)])
        d, c = sess.reader()([a], [b])
        assert (int(d[0]), int(c[0])) == (1, 1)
        res = plain_spc_bfs(sharded.graph, a)
        d, c = sess.reader()(np.full(n, a), np.arange(n))
        assert torch.equal(d, res.dist[:n]) and torch.equal(c, res.cnt[:n])


def test_dien_and_a_smoke_train_step_on_the_card_equal_the_cpu(card):
    """DIEN at ``SMOKE``: ``forward`` and ``retrieval_scores`` within
    rtol 1e-4 / atol 1e-5 of the CPU with the same weights, the train
    loss and every gradient within 1e-4 / 1e-6; one AdamW step of the
    qwen2-1.5b ``SMOKE`` configuration in float32 through
    ``loop.make_train_step`` within rtol 1e-4 / atol 1e-5 of the CPU's
    (loss, parameters, moments), launching no kernel of the port."""
    from repro_torch.configs.dien import SMOKE as DIEN_SMOKE
    from repro_torch.configs.qwen2_1_5b import SMOKE as LM_SMOKE
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.models import dien as D
    from repro_torch.train import loop as L
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import flatten
    counters = (launches, SM.launches, EB.launches, FD.launches)
    before = [c.count for c in counters]
    params = D.init_params(DIEN_SMOKE, device="cpu")
    batch = chip_smoke.dien_inputs(DIEN_SMOKE, 0, 32, 1, "cpu")
    cand = {"item": torch.arange(0, 500, 7, dtype=torch.int32),
            "cate": torch.arange(0, 500, 7, dtype=torch.int32) % 20}
    got, want = {}, {}
    for dev, out in (("cpu", want), ("cuda", got)):
        p = O.tree_map(lambda x: x.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        c = {k: v.to(dev) for k, v in cand.items()}
        with torch.no_grad():
            out["forward"] = D.forward(p, b, DIEN_SMOKE).cpu()
            out["retrieval"] = D.retrieval_scores(p, b, c, DIEN_SMOKE).cpu()
        loss, grads = L.value_and_grad(D.make_train_loss(DIEN_SMOKE), p, b)
        out["loss"], out["grads"] = loss.cpu(), chip_smoke.on_cpu(grads)
    for key in ("forward", "retrieval"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(flatten(got["grads"])[0], flatten(want["grads"])[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    cfg = dataclasses.replace(LM_SMOKE, tp=1, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    lm = tf.init_params(cfg, device="cpu")
    toks = lm_batch(0, 2, 16, cfg.vocab, seed=3)
    step = L.make_train_step(tf.make_train_loss(cfg), O.AdamWConfig())
    res = {}
    for dev in ("cpu", "cuda"):
        p = O.tree_map(lambda x: x.to(dev), lm)
        p2, st, stats = step(p, O.init(p, O.AdamWConfig()),
                             chip_smoke.tensors(toks, dev))
        res[dev] = (chip_smoke.on_cpu(p2), chip_smoke.on_cpu(st.mu),
                    float(stats["loss"]), int(stats["skipped"]))
    assert res["cuda"][3] == res["cpu"][3] == 0
    assert res["cuda"][2] == pytest.approx(res["cpu"][2], rel=1e-4)
    for part in (0, 1):
        for a, b in zip(flatten(res["cuda"][part])[0],
                        flatten(res["cpu"][part])[0]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert [c.count for c in counters] == before


#: K4's LSE output on both routes: the CUDA-core route in float32 and
#: bfloat16, the tensor-core route in bfloat16 (D 64, 128), groups of 1,
#: 6, 7 and 16, ragged lengths with a row of length 0.
LSE_SHAPES = [(4, 1, 1, 333, 32), (3, 12, 2, 2000, 128), (5, 28, 4, 1030, 128),
              (4, 16, 1, 700, 64)]


@pytest.mark.parametrize("b,h,kvh,s,d", LSE_SHAPES)
def test_flash_decode_lse_output_on_both_routes(card, b, h, kvh, s, d):
    """``return_lse``: each row's log-sum-exp of its masked scaled scores
    within 1e-4 of the plain version (bfloat16: on the float32 copies of
    the same inputs), ``-inf`` at length 0, and the outputs bit for bit
    those of the call without it; one launch each."""
    rng = np.random.default_rng(b * s + h)
    q, k, v, lengths = chip_smoke.decode_inputs(b, h, kvh, s, d, rng, card)
    lengths[-1] = 0
    runs = [("simt", torch.float32, FD.kernel._simt_cuda),
            ("simt", torch.bfloat16, FD.kernel._simt_cuda)]
    if d in FD.kernel.MMA_HEAD_DIMS:
        runs.append(("mma", torch.bfloat16, FD.flash_decode_cuda))
    for route, dtype, fn in runs:
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        want, want_lse = FD.decode_attention_ref(
            qd.float(), kd.float(), vd.float(), lengths, return_lse=True)
        before = FD.launches.count
        got, lse = fn(qd, kd, vd, lengths, return_lse=True)
        plain = fn(qd, kd, vd, lengths)
        torch.cuda.synchronize()
        assert FD.launches.count == before + 2
        assert lse.dtype == torch.float32 and lse.shape == (b, h)
        assert torch.equal(got, plain), route
        assert torch.isneginf(lse[-1]).all() and not got[-1].any()
        torch.testing.assert_close(lse[:-1], want_lse[:-1], rtol=0,
                                   atol=1e-4)
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_sharded_decode_on_four_cuda_entries_equals_the_cpu(card, arch):
    """The sequence-sharded decode over a mesh of four ``cuda:0``
    entries (s_max 13: shards of 4, 4, 4 and 1 positions) in float32:
    prefill and 4 steps give the CPU mesh's logits within 1e-4 and the
    unsharded card decode's; GQA launches K4 once a layer, step and
    shard, MLA none."""
    from repro_torch.configs.deepseek_v2_lite_16b import SMOKE as DS
    from repro_torch.configs.qwen2_1_5b import SMOKE as LM_SMOKE
    from repro_torch.launch.mesh import gather, make_mesh
    from repro_torch.train.optimizer import tree_map
    base = LM_SMOKE if arch == "gqa" else DS
    cfg = dataclasses.replace(base, tp=1, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    params = tf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        mesh = make_mesh((4,), ("model",), [dev] * 4)
        logits, cache = tf.prefill(p, toks.to(dev), cfg, 13, mesh=mesh)
        _, plain = tf.prefill(p, toks.to(dev), cfg, 13)
        tok, got, ref = logits.argmax(-1).to(torch.int32), [], []
        before = FD.launches.count
        for _ in range(4):
            a, cache = tf.decode_step(p, cache, tok, cfg)
            launched = FD.launches.count
            b, plain = tf.decode_step(p, plain, tok, cfg)
            before += FD.launches.count - launched
            got.append(a.cpu())
            ref.append(b.cpu())
            tok = a.argmax(-1).to(torch.int32)
        n1 = tf.cache_names(cfg)[0]
        out[dev] = (torch.stack(got), torch.stack(ref),
                    gather(cache[n1], "cpu"), FD.launches.count - before)
    for dev in ("cpu", "cuda"):
        torch.testing.assert_close(out[dev][0], out[dev][1], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                               atol=1e-4)
    assert out["cpu"][3] == 0
    assert out["cuda"][3] == (cfg.n_layers * 4 * 4 if arch == "gqa" else 0)


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_tp_serve_on_four_cuda_entries_equals_the_cpu(card, arch):
    """The tensor-parallel serve path (the weights placed over a
    ``("model",)`` mesh of four ``cuda:0`` entries, tp 4) in float32:
    prefill and 4 decode steps give the CPU mesh's logits within 1e-4;
    GQA launches K4 once a layer, step and cache shard, MLA none."""
    from repro_torch.configs.deepseek_v2_lite_16b import SMOKE as DS
    from repro_torch.configs.qwen2_7b import SMOKE as LM_SMOKE
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import tree_map
    base = LM_SMOKE if arch == "gqa" else DS
    cfg = dataclasses.replace(base, tp=4, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    params = tf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = make_mesh((4,), ("model",), [dev] * 4)
        placed = tf.place_params(tree_map(lambda x: x.to(dev), params), cfg,
                                 mesh)
        before = FD.launches.count
        logits, cache = tf.prefill(placed, toks.to(dev), cfg, 16)
        tok, got = logits.argmax(-1).to(torch.int32), [logits.cpu()]
        for _ in range(4):
            logits, cache = tf.decode_step(placed, cache, tok, cfg)
            got.append(logits.cpu())
            tok = logits.argmax(-1).to(torch.int32)
        out[dev] = (torch.stack(got), FD.launches.count - before)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert out["cpu"][1] == 0
    assert out["cuda"][1] == (cfg.n_layers * 4 * 4 if arch == "gqa" else 0)


def test_ring_on_the_card_equals_the_cpu(card):
    """The ring-partitioned Equiformer-v2 (a small config) over a (2, 2)
    mesh of ``cuda:0`` entries gives the CPU mesh's node irreps within
    rtol 1e-4 / atol 1e-5, and the card's local forward's; no kernel of
    the port launches."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import ring as RG
    from repro_torch.models.gnn.equiformer_v2 import (EquiformerV2,
                                                      EquiformerV2Config)
    from repro_torch.models.gnn.graph import from_numpy
    cfg = EquiformerV2Config(d_in=6, n_layers=2, d_hidden=8, l_max=2,
                             m_max=1, n_heads=2, n_rbf=8)
    rng = np.random.default_rng(0)
    n, e = 30, 90
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = snd != rcv
    snd, rcv = snd[keep].astype(np.int32), rcv[keep].astype(np.int32)
    src_b, dst_b, _, dropped = RG.bucket_edges(snd, rcv, n, 2, 2)
    nodes, pblk, _ = RG.blocked_layout(feat, pos, n, 2)
    assert dropped == 0
    cpu_model = EquiformerV2(cfg, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        model = chip_smoke.gnn_cast(cpu_model, torch.float32, dev)
        mesh = make_mesh((2, 2), ("data", "model"), [dev] * 4)
        before = [c.count for c in (launches, SM.launches, EB.launches,
                                    FD.launches)]
        with torch.no_grad():
            x = RG.forward_ring(model, torch.from_numpy(nodes).to(dev),
                                torch.from_numpy(pblk).to(dev), src_b, dst_b,
                                mesh)
            local = model(from_numpy(feat, snd, rcv, pos=pos,
                                     device=dev))[1][:n]
        assert [c.count for c in (launches, SM.launches, EB.launches,
                                  FD.launches)] == before
        out[dev] = (RG.unblock(x, n, 2).cpu(), local.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cuda"][1], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-5)
