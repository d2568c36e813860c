"""Parity of the port's query cores and its ``spc_query`` kernel module
with the JAX reference.

On the CPU the kernel wrapper takes its plain version (an int64 L x L
table); it must agree with the reference's ``spc_query_ref`` (fp32
counts: equal wherever the count is below 2^24), with the Pallas kernel
in interpret mode through ``index_query_batch``, and with both
packages' ``merge_rows``.  Counts of 2^24 + 1 and above 2^32 come back
exact.  The index form (``exact_query_batch``: rows read by vertex id)
equals the reference's ``index_query_batch`` bit for bit on a real
index, on rows that repeat hubs, at ids 0, n - 1 and n and at ids
outside [0, n] (a negative id wraps once, then the row is clamped to
[0, n], as ``jnp`` indexing reads it), and gives empty answers for no
pairs.  The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import labels as JL
from repro.core import query as JQ
from repro.kernels.spc_query.ops import index_query_batch
from repro.kernels.spc_query.ref import spc_query_ref as jax_spc_query_ref
from repro_torch.core import query as TQ
from repro_torch.core.dynamic import DynamicSPC
from repro_torch.data import random_graph_edges
from repro_torch.kernels.spc_query import (exact_query_batch, launches, plan,
                                           prep_rows, spc_query,
                                           spc_query_cuda,
                                           spc_query_index_cuda,
                                           spc_query_ref, wrap_ids)

INF = 1 << 28
SWEEP = [(4, 8), (130, 16), (256, 32), (17, 128)]


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def eq(a, b):
    a, b = host(a), host(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def tpu_sweep_rows(b, l_cap):
    """The inputs of the reference's TestSpcQueryKernel sweep (sorted
    hubs drawn with replacement), counts as int64."""
    r = np.random.default_rng(b * l_cap)
    hub_s = np.sort(r.integers(0, 50, (b, l_cap))).astype(np.int32)
    hub_t = np.sort(r.integers(0, 50, (b, l_cap))).astype(np.int32)
    dist_s = r.integers(0, 12, (b, l_cap)).astype(np.int32)
    dist_t = r.integers(0, 12, (b, l_cap)).astype(np.int32)
    cnt_s = r.integers(1, 9, (b, l_cap)).astype(np.int64)
    cnt_t = r.integers(1, 9, (b, l_cap)).astype(np.int64)
    return hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t


def label_rows(b, l_cap, seed):
    """Kernel-ready rows as an index holds them: distinct sorted hubs,
    s side padded with n, t side with n + 1, pad dist INF, pad cnt 0."""
    r = np.random.default_rng(seed)
    n = max(50, 2 * l_cap)
    out = []
    for pad in (n, n + 1):
        hub = np.full((b, l_cap), pad, np.int32)
        dist = np.full((b, l_cap), INF, np.int32)
        cnt = np.zeros((b, l_cap), np.int64)
        for i in range(b):
            k = int(r.integers(0, l_cap + 1))
            hub[i, :k] = np.sort(r.choice(n, size=k, replace=False))
            dist[i, :k] = r.integers(0, 12, k)
            cnt[i, :k] = r.integers(1, 9, k)
        out += [hub, dist, cnt]
    return tuple(out)


def as_torch(rows):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in rows)


def as_jax(rows):
    return tuple(jnp.asarray(x) for x in rows)


@pytest.mark.parametrize("b,l_cap", SWEEP)
def test_plain_version_matches_reference_on_tpu_sweep(b, l_cap):
    rows = tpu_sweep_rows(b, l_cap)
    d_t, c_t = spc_query(*as_torch(rows))        # CPU: the plain version
    j = as_jax(rows)
    d_j, c_j = jax_spc_query_ref(*j[:2], j[2].astype(jnp.float32),
                                 *j[3:5], j[5].astype(jnp.float32))
    assert d_t.dtype == torch.int32 and c_t.dtype == torch.int64
    eq(d_t, d_j)
    c_j = host(c_j)
    assert c_j.max() < 2 ** 24  # the fp32 reference is exact here
    np.testing.assert_array_equal(host(c_t), c_j.astype(np.int64))


@pytest.mark.parametrize("b,l_cap", SWEEP)
def test_plain_version_matches_merge_on_label_rows(b, l_cap):
    rows = label_rows(b, l_cap, seed=b + l_cap)
    d_t, c_t = spc_query_ref(*as_torch(rows))
    for d, c in (TQ.merge_rows(*as_torch(rows)),
                 JQ.merge_rows(*as_jax(rows)),
                 JQ.table_rows(*as_jax(rows), jnp.int32(10 ** 6))):
        eq(d_t, d)
        eq(c_t, c)


@pytest.fixture(scope="module")
def real_index():
    """A built and updated power-law index, as port and JAX SPCIndex."""
    n = 40
    edges = random_graph_edges(n, 100, seed=12)
    svc = DynamicSPC(n, edges, l_cap=8, device="cpu")
    svc.apply_events([("+", 0, 39), ("-",) + edges[5], ("+", 3, 38)])
    st = svc.state_dict()
    jidx = JL.SPCIndex(
        hub=jnp.asarray(st["index.hub"]), dist=jnp.asarray(st["index.dist"]),
        cnt=jnp.asarray(st["index.cnt"]), size=jnp.asarray(st["index.size"]),
        cnt_sum=jnp.asarray(st["index.cnt_sum"]), overflow=jnp.int32(0),
        n=n)
    r = np.random.default_rng(0)
    s = r.integers(0, n, 96).astype(np.int32)
    t = r.integers(0, n, 96).astype(np.int32)
    return svc.index, jidx, s, t


def test_kernel_module_matches_pallas_on_real_index(real_index):
    tidx, jidx, s, t = real_index
    rows_t = prep_rows(tidx, s, t)
    from repro.kernels.spc_query.ops import prep_rows as jax_prep_rows
    for a, b in zip(rows_t, jax_prep_rows(jidx, jnp.asarray(s),
                                          jnp.asarray(t))):
        eq(a, b)
    d_t, c_t = exact_query_batch(tidx, s, t)
    d_p, c_p = index_query_batch(jidx, jnp.asarray(s), jnp.asarray(t),
                                 interpret=True)
    eq(d_t, d_p)
    eq(c_t, c_p)
    d_m, c_m = JQ.batched_query_merge(jidx, jnp.asarray(s), jnp.asarray(t))
    eq(d_t, d_m)
    eq(c_t, c_m)


def test_query_cores_match_reference(real_index):
    tidx, jidx, s, t = real_index
    n = tidx.n
    js, jt = jnp.asarray(s), jnp.asarray(t)
    for (dt, ct), (dj, cj) in (
            (TQ.batched_query(tidx, s, t), JQ.batched_query(jidx, js, jt)),
            (TQ.batched_query_merge(tidx, s, t),
             JQ.batched_query_merge(jidx, js, jt))):
        eq(dt, dj)
        eq(ct, cj)
    rows_t = TQ.gather_rows(tidx, torch.from_numpy(s).long()) + \
        TQ.gather_rows(tidx, torch.from_numpy(t).long())
    rows_j = JQ.gather_rows(jidx, js) + JQ.gather_rows(jidx, jt)
    for limit in (n + 1, 7, torch.from_numpy(s)):
        jl = limit if isinstance(limit, int) else js
        dt, ct = TQ.table_rows(*rows_t, limit)
        dj, cj = jax.vmap(JQ._intersect)(
            *rows_j, jnp.broadcast_to(jnp.asarray(jl, jnp.int32), js.shape))
        eq(dt, dj)
        eq(ct, cj)
    eq(TQ.count_upper_bound_rows(rows_t[2], rows_t[5]),
       JQ.count_upper_bound_rows(rows_j[2], rows_j[5]))
    eq(TQ.cached_count_bound(tidx, s, t), JQ.cached_count_bound(jidx, js, jt))
    for a, b in ((0, 5), (7, 3), (12, 12), (39, 1)):
        for ft, fj in ((TQ.pair_query, JQ.pair_query),
                       (TQ.pre_pair_query, JQ.pre_pair_query)):
            dt, ct = ft(tidx, a, b)
            dj, cj = fj(jidx, a, b)
            assert (int(dt), int(ct)) == (int(dj), int(cj)), (ft, a, b)
    roots = [0, 3, 17, n - 1, n]
    for h in roots:
        for limit in (None, h, 5):
            for xt, xj in zip(TQ.dense_tables(tidx, h, limit),
                              JQ.dense_tables(jidx, h, limit)):
                eq(xt, xj)
            for xt, xj in zip(TQ.one_to_all(tidx, h, limit),
                              JQ.one_to_all(jidx, h, limit)):
                eq(xt, xj)
    # the batched builder's distance-only one-to-all, chunked over roots
    for limit in (0, 9):
        want = np.stack([host(JQ.one_to_all(jidx, h, limit)[0])
                         for h in roots])
        got = TQ.one_to_all_dist_batch(tidx, torch.tensor(roots), limit)
        np.testing.assert_array_equal(host(got), want)


def test_one_to_all_cols_equals_reference_rows(real_index, monkeypatch):
    """The column-restricted one-to-all rows equal the reference's full
    rows at those columns, in one chunk of roots and in several."""
    tidx, jidx, _, _ = real_index
    n = tidx.n
    roots = [0, 3, 17, n - 1, n]
    cols = [n - 1, 2, 0, 17, 9, 2]
    want = [np.stack([host(JQ.one_to_all(jidx, h)[k])[cols] for h in roots])
            for k in (0, 1)]
    for elems in (TQ._ONE_TO_ALL_ELEMS, 4 * len(cols) * tidx.l_cap):
        monkeypatch.setattr(TQ, "_ONE_TO_ALL_ELEMS", elems)
        for got, w in zip(TQ.one_to_all_cols(tidx, torch.tensor(roots),
                                             torch.tensor(cols)), want):
            eq(got, w)


def _two_hop_index(counts):
    """Vertex 0 reaches vertex 1 through hub 0 with the given count."""
    n, l_cap = 3, 4
    hub = np.full((n + 1, l_cap), n, np.int32)
    dist = np.full((n + 1, l_cap), INF, np.int32)
    cnt = np.zeros((n + 1, l_cap), np.int64)
    size = np.zeros(n + 1, np.int32)
    rows = {0: [(0, 0, 1)], 1: [(0, 1, counts[0]), (1, 0, 1)],
            2: [(0, 2, counts[1]), (2, 0, 1)]}
    for v, labels in rows.items():
        for j, (h, d, c) in enumerate(labels):
            hub[v, j], dist[v, j], cnt[v, j] = h, d, c
        size[v] = len(labels)
    return n, (hub, dist, cnt, size)


def test_counts_above_2_24_and_2_32_are_exact():
    big24, big32 = 2 ** 24 + 1, 2 ** 33 + 7
    n, arrays = _two_hop_index((big24, big32))
    from repro_torch.core.labels import index_from_numpy
    tidx = index_from_numpy(n, *arrays, device="cpu")
    jidx = JL.SPCIndex(*(jnp.asarray(a) for a in arrays),
                       cnt_sum=JL.recompute_cnt_sum(jnp.asarray(arrays[2])),
                       overflow=jnp.int32(0), n=n)
    d, c = exact_query_batch(tidx, [0, 0, 1], [1, 2, 2])
    assert d.tolist() == [1, 2, 3]
    assert c.tolist() == [big24, big32, big24 * big32]
    assert c.tolist()[0] == 16777217
    # the reference reaches the same exact counts only through its
    # int64 merge fallback; its fp32 kernel rounds 2^24 + 1
    d_j, c_j = index_query_batch(jidx, jnp.asarray([0, 0, 1]),
                                 jnp.asarray([1, 2, 2]), interpret=True)
    eq(d, d_j)
    eq(c, c_j)
    _, c_raw = index_query_batch(jidx, jnp.asarray([0]), jnp.asarray([1]),
                                 interpret=True, exact=False)
    assert float(c_raw[0]) == 2 ** 24


def test_wrapper_dispatch_never_falls_back():
    rows = as_torch(label_rows(5, 8, seed=1))
    before = launches.count
    spc_query(*rows)  # CPU tensors: the plain version, not a launch
    assert launches.count == before
    with pytest.raises(ValueError, match="CUDA"):
        spc_query_cuda(*rows)
    d, c = spc_query(*(r[:0] for r in rows))
    assert d.shape == (0,) and c.dtype == torch.int64


def _edge_and_outside_ids(n):
    """(s, t): ids 0, n - 1 and n (the dump row), then ids outside
    [0, n]: -1, -(n + 1), -(n + 5), n + 3, paired every way."""
    edge = [0, n - 1, n]
    outside = [-1, -(n + 1), -(n + 5), n + 3]
    pairs = [(a, b) for a in edge + outside for b in edge + outside]
    return (np.asarray([a for a, _ in pairs], np.int64),
            np.asarray([b for _, b in pairs], np.int64))


def test_wrap_ids_follows_the_reference_gather_rule(real_index):
    """A negative id wraps once, then the row is clamped to [0, n]: what
    ``jnp`` indexing does (``x[[-1, -6, 9]]`` on 5 rows reads 4, 0, 4)."""
    tidx, _, _, _ = real_index
    n = tidx.n
    ids = np.asarray([-1, -6, 9, -(n + 1), -(n + 5), n + 3, 0, n], np.int64)
    want = np.asarray(jnp.arange(n + 1)[jnp.asarray(ids)])
    np.testing.assert_array_equal(host(wrap_ids(tidx, ids)), want)
    assert np.asarray(jnp.arange(5)[jnp.asarray([-1, -6, 9])]).tolist() == \
        [4, 0, 4]


@pytest.mark.parametrize("ids", ["random", "edge and outside"])
def test_index_form_plain_version_matches_reference(real_index, ids):
    """The index form (rows read by vertex id) on the CPU against the
    reference's ``index_query_batch`` with the Pallas kernel in interpret
    mode, bit for bit: random pairs, then ids 0, n - 1, n and ids outside
    [0, n] under the reference's wrap-and-clamp rule."""
    tidx, jidx, s, t = real_index
    if ids != "random":
        s, t = _edge_and_outside_ids(tidx.n)
    before = launches.count
    d_t, c_t = exact_query_batch(tidx, s, t)
    assert launches.count == before          # the CPU: no launch
    d_j, c_j = index_query_batch(jidx, jnp.asarray(s), jnp.asarray(t),
                                 interpret=True)
    eq(d_t, d_j)
    eq(c_t, c_j)
    assert (host(d_t) < INF).any()


def repeated_hub_index(n=30, l_cap=16, seed=3):
    """An index whose rows repeat hubs (sorted, drawn with replacement
    from 12 hubs), pads hub n, dist INF, cnt 0; counts small enough that
    the reference answers every row with its L x L kernel."""
    r = np.random.default_rng(seed)
    hub = np.full((n + 1, l_cap), n, np.int32)
    dist = np.full((n + 1, l_cap), INF, np.int32)
    cnt = np.zeros((n + 1, l_cap), np.int64)
    size = np.zeros(n + 1, np.int32)
    for v in range(n):
        k = int(r.integers(1, l_cap + 1))
        hub[v, :k] = np.sort(r.integers(0, 12, k))
        dist[v, :k] = r.integers(0, 6, k)
        cnt[v, :k] = r.integers(1, 4, k)
        size[v] = k
    return n, (hub, dist, cnt, size)


def test_index_form_counts_every_pair_of_repeated_hubs():
    from repro_torch.core.labels import index_from_numpy
    n, arrays = repeated_hub_index()
    tidx = index_from_numpy(n, *arrays, device="cpu")
    jidx = JL.SPCIndex(*(jnp.asarray(a) for a in arrays),
                       cnt_sum=JL.recompute_cnt_sum(jnp.asarray(arrays[2])),
                       overflow=jnp.int32(0), n=n)
    r = np.random.default_rng(4)
    s, t = r.integers(0, n, 64), r.integers(0, n, 64)
    d_t, c_t = exact_query_batch(tidx, s, t)
    d_j, c_j = index_query_batch(jidx, jnp.asarray(s), jnp.asarray(t),
                                 interpret=True)
    eq(d_t, d_j)
    eq(c_t, c_j)
    # a single probe per hub (the merge) misses pairs on these rows
    _, c_m = TQ.batched_query_merge(tidx, s, t)
    assert (host(c_m) < host(c_t)).any()


def test_index_form_of_no_pairs(real_index):
    """B = 0 gives empty answers of the right dtypes, as the reference's
    merge route does; the reference's ``index_query_batch`` raises there
    (its kernel slices a block of 128 rows out of 0)."""
    tidx, jidx, _, _ = real_index
    none = np.zeros(0, np.int64)
    d, c = exact_query_batch(tidx, none, none)
    d_j, c_j = JQ.batched_query_merge(jidx, jnp.asarray(none),
                                      jnp.asarray(none))
    eq(d, d_j)
    eq(c, c_j)
    with pytest.raises(TypeError, match="slice_sizes"):
        index_query_batch(jidx, jnp.asarray(none), jnp.asarray(none),
                          interpret=True)


def test_index_wrapper_and_plan_on_the_cpu():
    """The index form's wrapper raises on CPU tensors (the plain version
    is the ops' business there); the plan stages rows of up to 16384
    labels in shared memory."""
    from repro_torch.core.labels import empty_index
    from repro_torch.kernels.spc_query.kernel import _warp_cuda
    idx = empty_index(5, 8, device="cpu")
    ids = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        _warp_cuda(*as_torch(label_rows(3, 8, seed=2)))
    assert plan(2048) == "staged" and plan(16384) == "staged"
    assert plan(16385) == "global"
