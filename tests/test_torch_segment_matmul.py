"""The port's segment_matmul against the reference's.

The same numpy inputs, made from seeds, go through
``repro.kernels.segment_matmul`` (its Pallas kernel in interpret mode,
its ``segment_matmul_ref`` and its ops) and through the port's plain
version and ops, which is the route of CPU tensors.  Float32 within
rtol = atol = 1e-6 (only the order of the float32 sums differs);
bfloat16 within 1e-2 of the float32 sum of the same values, as
``tests/kernels/test_kernels.py`` holds the Pallas kernel.  The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_matmul.kernel import segment_matmul_pallas
from repro.kernels.segment_matmul.ops import gather_scatter as jax_gather
from repro.kernels.segment_matmul.ops import scatter_add as jax_scatter
from repro.kernels.segment_matmul.ref import segment_matmul_ref as jax_ref
from repro_torch.core.bfs import edge_relax
from repro_torch.core.graph import from_edges
from repro_torch.data import random_graph_edges
from repro_torch.kernels.segment_matmul import (gather_scatter, launches,
                                                scatter_add,
                                                segment_matmul_cuda,
                                                segment_matmul_ref)
from repro_torch.kernels.segment_matmul import kernel as SMK

#: tests/kernels/test_kernels.py::TestSegmentMatmul (e, n, d, block_e,
#: block_n).
SWEEP = [(100, 30, 16, 32, 16), (1000, 128, 64, 256, 128),
         (513, 65, 8, 128, 32), (64, 300, 4, 64, 128)]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(e, n, d, lo=0):
    """vals N(0, 1) [e, d] and ids over [lo, n + 5), drawn as the
    reference's sweep draws them."""
    r = np.random.default_rng(e + n)
    vals = r.standard_normal((e, d))
    dst = r.integers(lo, n + 5, e).astype(np.int32)
    return vals, dst


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("e,n,d,be,bn", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_reference_sweep(e, n, d, be, bn, dtype):
    jdt, tdt = DTYPES[dtype]
    vals, dst = _inputs(e, n, d)
    vals_j, dst_j = jnp.asarray(vals, jdt), jnp.asarray(dst, jnp.int32)
    got = segment_matmul_ref(torch.from_numpy(vals).to(tdt),
                             torch.from_numpy(dst), n)
    assert got.dtype == tdt and got.shape == (n, d)
    pallas = segment_matmul_pallas(vals_j, dst_j, n, block_e=be, block_n=bn,
                                   interpret=True)
    if dtype == "float32":
        for want in (pallas, jax_ref(vals_j, dst_j, n)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6)
    else:
        truth = jax_ref(vals_j.astype(jnp.float32), dst_j, n)
        for out in (got, pallas):
            np.testing.assert_allclose(_np(out), _np(truth), rtol=1e-2,
                                       atol=1e-2)


@pytest.mark.parametrize("lo", [0, -7])
def test_drops_negative_and_out_of_range_ids_like_the_reference(lo):
    """Ids below 0 and from n on, unsorted, are dropped by both the
    reference's plain version and its Pallas kernel, and by the port."""
    e, n, d = 300, 20, 8
    vals, dst = _inputs(e, n, d, lo)
    assert (dst >= n).any() and ((dst < 0).any() or lo == 0)
    assert (np.diff(dst) < 0).any()
    vals_j, dst_j = jnp.asarray(vals, jnp.float32), jnp.asarray(dst)
    got = segment_matmul_ref(torch.from_numpy(vals).float(),
                             torch.from_numpy(dst), n)
    for want in (jax_ref(vals_j, dst_j, n),
                 segment_matmul_pallas(vals_j, dst_j, n, block_e=64,
                                       block_n=16, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    keep = (dst >= 0) & (dst < n)
    sums = np.zeros((n, d))
    np.add.at(sums, dst[keep], vals[keep])
    np.testing.assert_allclose(_np(got), sums, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_no_edges_gives_zeros_in_the_dtype_of_vals(dtype):
    jdt, tdt = DTYPES[dtype]
    vals = torch.zeros((0, 6), dtype=tdt)
    dst = torch.zeros(0, dtype=torch.int32)
    got = segment_matmul_ref(vals, dst, 5)
    want = jax_ref(jnp.zeros((0, 6), jdt), jnp.zeros(0, jnp.int32), 5)
    assert got.dtype == tdt and got.shape == (5, 6) == want.shape
    assert not got.any() and not np.asarray(want, np.float32).any()
    assert scatter_add(vals, dst, 0).shape == (0, 6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_match_the_reference_ops(dtype):
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(9)
    n, e, d = 40, 500, 12
    feats = r.standard_normal((n, d))
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(-2, n + 3, e).astype(np.int32)
    feats_j, src_j, dst_j = (jnp.asarray(feats, jdt), jnp.asarray(src),
                             jnp.asarray(dst))
    feats_t, src_t, dst_t = (torch.from_numpy(feats).to(tdt),
                             torch.from_numpy(src), torch.from_numpy(dst))
    # bfloat16: the port accumulates in float32 and is held to the float32
    # sum of the same values (the reference's XLA route sums in bfloat16)
    truth_j = jax_gather(feats_j.astype(jnp.float32), src_j, dst_j, n)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for use_kernel in (False, True):
        kw = {"use_kernel": True, "interpret": True} if use_kernel else {}
        for got, want in (
                (scatter_add(feats_t[src_t.long()], dst_t, n),
                 jax_scatter(feats_j[src_j], dst_j, n, **kw)),
                (gather_scatter(feats_t, src_t, dst_t.long(), n),
                 jax_gather(feats_j, src_j, dst_j, n, **kw))):
            assert got.dtype == tdt
            np.testing.assert_allclose(
                _np(got), _np(want if dtype == "float32" else truth_j),
                rtol=tol, atol=tol)


def test_relaxation_form_matches_segment_sum_and_edge_relax():
    """The DSPC edge relaxation as a segment sum of float32 counts (the
    reference's test_matches_bfs_relaxation form): equal to
    ``jax.ops.segment_sum`` and, exactly, to the port's int64
    ``edge_relax``."""
    n = 60
    g = from_edges(n, random_graph_edges(n, 150, seed=4), device="cpu")
    r = np.random.default_rng(6)
    cnt = torch.from_numpy(r.integers(1, 5, n + 1))
    frontier = torch.from_numpy(r.random(n + 1) < 0.5)
    frontier[n] = False
    src, dst = g.src[:g.m2], g.dst[:g.m2]
    contrib = torch.where(frontier[src], cnt[src], 0).float()[:, None]
    got = scatter_add(contrib, dst, n + 1)[:, 0]
    want = jax.ops.segment_sum(jnp.asarray(contrib[:, 0].numpy()),
                               jnp.asarray(dst.numpy()), num_segments=n + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    relaxed = edge_relax(src, dst, cnt, frontier)
    assert relaxed.any()
    assert torch.equal(got.long(), relaxed)


def test_kernel_wrapper_takes_only_cuda_tensors():
    vals, dst = torch.zeros((4, 8)), torch.zeros(4, dtype=torch.int32)
    before = launches.count
    for fn in (segment_matmul_cuda, SMK._sorted_cuda, SMK._blocked_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(vals, dst, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_add(vals.to("meta"), dst.to("meta"), 3)
    assert launches.count == before


def test_kernel_source_sums_without_atomics():
    """Deterministic by construction: both designs add in a fixed order
    and never with an atomic; the blocked one has one kernel and no
    scratch in device memory, the sorted one three kernels."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                        "repro_torch", "csrc", "segment_matmul.cu")
    source = open(path).read()
    assert "src/repro/kernels/segment_matmul/kernel.py:34" in source
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert "atomic" not in code.lower()
    kernels = sorted(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        code))
    assert kernels == ["block_sums", "chunk_sums", "combine",
                       "segment_starts"]
    # the blocked design's one kernel takes no scratch in device memory
    blocked = code[code.index("block_sums("):code.index(") {", code.index(
        "block_sums("))]
    assert "partial" not in blocked and "starts" not in blocked
    assert 'extern "C" int segment_matmul_blocked_launch' in code


#: (E, N, D, dtype, design): the kernel microbench, the dspc graph's three
#: shapes (f32, bf16 aggregation; the relaxation), and the edges of the
#: blocked design's two conditions.
PLANS = [
    (16384, 2048, 128, torch.float32, "blocked"),       # the microbench
    (1048576, 65536, 128, torch.float32, "sorted"),     # the graph
    (1048576, 65536, 128, torch.bfloat16, "sorted"),
    (1048576, 65537, 1, torch.float32, "sorted"),       # the relaxation
    (16384, 2049, 128, torch.float32, "sorted"),        # 129 CTAs of ids
    (16384, 2048, 128, torch.bfloat16, "sorted"),       # ids > bf16 vals
    (16384, 1024, 128, torch.bfloat16, "blocked"),
    (65536, 2048, 128, torch.float32, "blocked"),       # 256 KB a CTA
    (65537, 2048, 128, torch.float32, "sorted"),
    (0, 7, 16, torch.float32, "blocked"),               # E = 0: one launch
    (100, 30, 256, torch.float32, "blocked"),           # 8 segments a CTA
    (100, 30, 257, torch.float32, "sorted"),            # too wide
    (64, 300, 4, torch.float32, "blocked"),           # 2 CTAs of 256
    (64, 3000, 4, torch.float32, "sorted"),           # 12 CTAs of ids
]


@pytest.mark.parametrize("e,n,d,dtype,design", PLANS)
def test_plan_picks_the_design_from_shapes(e, n, d, dtype, design):
    assert SMK.plan(e, n, d, dtype) == design
    nblk = SMK.block_segments(d)
    if design == "blocked":
        ctas = -(-n // nblk)
        elem = 4 if dtype == torch.float32 else 2
        assert 8 <= nblk and nblk * d <= SMK.BLOCK_ELEMS
        assert 4 * e * ctas <= e * d * elem <= ctas * SMK.BLOCK_VAL_BYTES
    if (e, n, d) == (16384, 2048, 128):
        assert nblk == 16 and -(-n // nblk) == 128


def test_summation_depth_of_each_design():
    assert SMK.summation_depth("sorted", 14329) == 128 + 111 + 2
    assert SMK.summation_depth("blocked", 40) == 40
