"""The port's kernel microbench (``repro_torch.bench.kernels_bench``)
against the reference's (``benchmarks/kernels_bench.py``).

Its input helpers give the reference's draws for a seed (the reference
functions are run with their kernels replaced by recorders, so the draw
is read off the reference's own code).  On those draws a hub often
repeats within a row: the port's plain ``spc_query_ref`` (int64 counts)
equals the reference's (float32 counts, exact at these sizes), and a
kernel that takes only the first entry of each hub's run in L(t) would
not.  The bench functions run on the CPU (plain versions only) and
refuse to run without a card when asked for the default ``"cuda"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import repro.kernels.segment_matmul.kernel as jax_segment_kernel
import repro.kernels.spc_query.kernel as jax_query_kernel
from benchmarks import kernels_bench as reference_bench
from repro.kernels.spc_query.ref import spc_query_ref as jax_query_ref
from repro_torch.bench import kernels_bench as KB
from repro_torch.kernels.segment_matmul.kernel import chunks
from repro_torch.kernels.spc_query.ref import INF, spc_query_ref
from repro_torch.models.common import dense_init


def _recording(store, key, result):
    def record(*args, **_):
        store[key] = [np.asarray(a) for a in args]
        return result(*args)
    return record


@pytest.mark.parametrize("seed", [0, 3])
def test_input_helpers_give_the_reference_draws(monkeypatch, seed):
    seen = {}
    monkeypatch.setattr(jax_query_kernel, "spc_query_pallas", _recording(
        seen, "query", lambda hs, ds, cs, *_: (ds[:, 0], cs[:, 0])))
    monkeypatch.setattr(jax_segment_kernel, "segment_matmul_pallas",
                        _recording(seen, "segment",
                                   lambda v, s, num_segments=None: v[:4]))
    reference_bench.query_kernel_vs_jnp(b=8, l=16, seed=seed)
    reference_bench.segment_matmul_vs_segment_sum(e=64, n=16, d=8, seed=seed)
    ours = KB.query_inputs(8, 16, seed)
    assert [x.dtype for x in ours] == [np.int32, np.int32, np.int64] * 2
    for got, want in zip(ours, seen["query"]):
        np.testing.assert_array_equal(got, want)
    vals, dst = KB.segment_inputs(64, 16, 8, seed)
    assert vals.dtype == np.float32 and dst.dtype == np.int32
    np.testing.assert_array_equal(vals, seen["segment"][0])
    np.testing.assert_array_equal(dst, seen["segment"][1])


def _first_entry_only(hs, ds, cs, ht, dt, ct, stop_at_inf=False):
    """(dist, count) per row if each label of L(s) met only the lower
    bound of its hub in L(t) -- or, with ``stop_at_inf``, the run of its
    hub up to the first entry at INF."""
    out_d, out_c = [], []
    for row in zip(hs, ds, cs, ht, dt, ct):
        h_s, d_s, c_s, h_t, d_t, c_t = (np.asarray(x) for x in row)
        best, count = 2 * INF, 0
        for h, d, c in zip(h_s, d_s, c_s):
            if d >= INF:
                continue
            p = int(np.searchsorted(h_t, h))
            end = p + 1 if not stop_at_inf else len(h_t)
            for q in range(p, min(end, len(h_t))):
                if h_t[q] != h or d_t[q] >= INF:
                    break
                s = int(d) + int(d_t[q])
                if s < best:
                    best, count = s, int(c) * int(c_t[q])
                elif s == best:
                    count += int(c) * int(c_t[q])
        out_d.append(best if best < INF else INF)
        out_c.append(count if best < INF else 0)
    return np.asarray(out_d), np.asarray(out_c)


def test_plain_version_equals_reference_on_the_microbench_rows():
    rows = KB.query_inputs(1024, 64, seed=0)
    d, c = spc_query_ref(*(torch.from_numpy(x) for x in rows))
    d_j, c_j = jax_query_ref(*(jnp.asarray(x, jnp.float32 if x.dtype ==
                                           np.int64 else jnp.int32)
                               for x in rows))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j).astype(np.int64))
    repeats = sum(len(np.unique(h)) < h.size for h in rows[0])
    assert repeats > 900                       # most rows repeat a hub
    d1, c1 = _first_entry_only(*rows)
    differ = int(((d1 != d.numpy()) | (c1 != c.numpy())).sum())
    assert differ > 20, differ                 # the rows that pin the fault


def test_hand_made_repeated_hub_pair_is_worked_out_right():
    rows, (want_d, want_c) = chip_smoke.repeated_hub_rows("cpu")
    d, c = spc_query_ref(*rows)
    assert (d.tolist(), c.tolist()) == (want_d, want_c) == ([2], [13])
    d_j, c_j = jax_query_ref(*(jnp.asarray(r.numpy(), jnp.float32 if
                                           r.dtype == torch.int64 else
                                           jnp.int32) for r in rows))
    assert (np.asarray(d_j).tolist(), np.asarray(c_j).tolist()) == ([2],
                                                                    [13.0])
    np_rows = [r.numpy() for r in rows]
    assert [x.tolist() for x in _first_entry_only(*np_rows)] == [[4], [6]]
    assert [x.tolist() for x in _first_entry_only(
        *np_rows, stop_at_inf=True)] == [[2], [8]]


def test_bench_functions_run_on_the_cpu(capsys):
    q, = KB.query_kernel_vs_plain(64, 16, seed=2, device="cpu")
    assert q["device"] == "cpu" and q["kernel_us_per_q"] is None
    assert (q["batch"], q["l_cap"]) == (64, 16) and q["plain_us_per_q"] > 0
    s, = KB.segment_matmul_vs_segment_sum(512, 64, 16, seed=2, device="cpu")
    _, dst = KB.segment_inputs(512, 64, 16, seed=2)
    assert s["device"] == "cpu" and s["kernel_ms"] is None
    assert s["longest_segment"] == int(np.bincount(dst).max())
    assert s["chunks"] == chunks(512) == 4
    assert s["plain_ms"] > 0 and s["index_add_ms"] > 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split(",") == list(q)
    assert "segment_matmul,cpu,512,64,16" in printed[4]


def test_cuda_defaults_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KB.query_kernel_vs_plain(8, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KB.segment_matmul_vs_segment_sum(16, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dense_init(3, 4, generator=torch.Generator().manual_seed(0))
