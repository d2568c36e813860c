"""The port's embedding_bag (``repro_torch.kernels.embedding_bag``)
against the reference's on the CPU: the plain version against
``embedding_bag_ref`` and the Pallas kernel in interpret mode, the ops
in sum and mean with ``pad_id``, and ``embedding_lookup``.  Tolerances:
rtol = atol = 1e-6 in float32 (only the summation order differs), and
1e-2 in bfloat16 against the float32 sum of the same bfloat16 rows (the
float32 truth of ``tests/kernels/test_kernels.py``).  The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag
from repro.kernels.embedding_bag.ops import embedding_lookup as jax_lookup
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels import common
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_cuda,
                                               embedding_bag_ref,
                                               embedding_lookup, launches)

SWEEP = [(4, 3, 16, 128), (32, 20, 1000, 16), (7, 1, 64, 32)]


def inputs(b, s, v, d):
    r = np.random.default_rng(b + v)
    ids = r.integers(0, v, (b, s)).astype(np.int32)
    table = r.standard_normal((v + 1, d)).astype(np.float32)
    table[v] = 0.0
    return ids, table


@pytest.mark.parametrize("b,s,v,d", SWEEP)
def test_plain_version_matches_reference_and_pallas(b, s, v, d):
    ids, table = inputs(b, s, v, d)
    got = embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(table))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    want = np.asarray(jax_ref(jnp.asarray(ids), jnp.asarray(table)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(embedding_bag_pallas(
        jnp.asarray(ids), jnp.asarray(table), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    table16 = torch.from_numpy(table).to(torch.bfloat16)
    half = embedding_bag_ref(torch.from_numpy(ids), table16)
    assert half.dtype == torch.bfloat16
    truth = jax_ref(jnp.asarray(ids), jnp.asarray(table16.float().numpy()))
    np.testing.assert_allclose(half.float().numpy(), np.asarray(truth),
                               rtol=1e-2, atol=1e-2)


def test_ids_outside_the_table_hit_the_zero_row():
    """The same ids, negatives included, through both packages: an id in
    [-(V + 1), -1] reads row V + 1 + id (from the end) in the port's
    plain version, the reference's plain version and its Pallas kernel;
    ids from V on read the zero row.  Below -(V + 1) the reference gives
    NaN (plain) and row 0 (Pallas); the port keeps the zero row there."""
    v = 20
    ids, table = inputs(6, 5, v, 8)
    ids[0, 1], ids[2, 4], ids[5, 0] = v, 10 ** 6, -3
    ids[1, 0], ids[3, 2], ids[4, 4] = -1, -(v + 1), -v
    got = embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(table))
    rows = np.where(ids < 0, ids + v + 1, np.minimum(ids, v))
    np.testing.assert_allclose(got.numpy(), table[rows].sum(axis=1),
                               rtol=1e-6, atol=1e-6)
    for want in (jax_ref(jnp.asarray(ids), jnp.asarray(table)),
                 embedding_bag_pallas(jnp.asarray(ids), jnp.asarray(table),
                                      interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the smallest input of the fault: V = 4, rows [1, 2] .. [7, 8]
    small = np.asarray([[1, 2], [3, 4], [5, 6], [7, 8], [0, 0]], np.float32)
    few = np.asarray([[-3], [-1], [-5], [4]], np.int32)
    got = embedding_bag_ref(torch.from_numpy(few), torch.from_numpy(small))
    assert got.tolist() == [[5, 6], [0, 0], [1, 2], [0, 0]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(embedding_bag_pallas(
        jnp.asarray(few), jnp.asarray(small), interpret=True)))
    # F2: below -(V + 1) the port keeps the zero row; the reference does not
    below = np.asarray([[-6], [-7], [-10 ** 6]], np.int32)
    got = embedding_bag_ref(torch.from_numpy(below), torch.from_numpy(small))
    assert not got.any()
    assert np.isnan(np.asarray(jax_ref(jnp.asarray(below),
                                       jnp.asarray(small)))[:2]).all()
    np.testing.assert_array_equal(np.asarray(embedding_bag_pallas(
        jnp.asarray(below), jnp.asarray(small), interpret=True))[:2],
        small[[0, 0]])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("b,s,v,d", SWEEP)
def test_ops_with_pad_id_match_reference(mode, b, s, v, d):
    ids, table = inputs(b, s, v, d)
    table = table[:v]                              # ops append the zero row
    pad = v + 7
    ids[2::3, 0] = -(v + 1)                        # from the end: row 0
    ids[3::4, -1] = -2                             # from the end: row v - 1
    ids[::2, -1] = pad
    ids[1, :] = pad                                # an all-pad bag: zeros
    got = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table),
                        mode=mode, pad_id=pad)
    want = jax_bag(jnp.asarray(ids), jnp.asarray(table), mode=mode,
                   pad_id=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    kernel = jax_bag(jnp.asarray(ids), jnp.asarray(table), mode=mode,
                     pad_id=pad, use_kernel=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-6,
                               atol=1e-6)
    assert not got[1].any()


def test_padding_and_mean_values():
    r = np.random.default_rng(11)
    v, d = 50, 8
    table = r.standard_normal((v, d)).astype(np.float32)
    ids = torch.tensor([[1, 2, 99], [3, 99, 99]], dtype=torch.int32)
    out = embedding_bag(ids, torch.from_numpy(table), mode="mean",
                        pad_id=99).numpy()
    np.testing.assert_allclose(out[0], (table[1] + table[2]) / 2, rtol=1e-6)
    np.testing.assert_allclose(out[1], table[3], rtol=1e-6)
    with pytest.raises(ValueError):
        embedding_bag(ids, torch.from_numpy(table), mode="max")


def test_lookup_matches_reference():
    r = np.random.default_rng(13)
    table = r.standard_normal((10, 4)).astype(np.float32)
    ids = np.asarray([[0, 9], [5, 10], [12, 3]], np.int32)
    got = embedding_lookup(torch.from_numpy(ids), torch.from_numpy(table),
                           pad_id=10)
    want = jax_lookup(jnp.asarray(ids), jnp.asarray(table), pad_id=10)
    assert got.shape == (3, 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1, 1].any()


def test_no_fallback_off_the_cpu():
    """The kernel wrapper takes CUDA tensors only, and the ops raise on
    any device that is neither the CPU nor CUDA; nothing is built."""
    ids, table = inputs(4, 3, 16, 8)
    before = launches.count
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.from_numpy(ids), torch.from_numpy(table))
    with pytest.raises(ValueError, match="unsupported device"):
        embedding_bag(torch.from_numpy(ids).to("meta"),
                      torch.from_numpy(table[:16]).to("meta"))
    assert launches.count == before
    assert "embedding_bag" not in common._loaded
    path = common.library_path("embedding_bag")
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("libembedding_bag-")
