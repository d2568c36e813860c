"""The port's flash_decode (``repro_torch.kernels.flash_decode``) against
the reference's on the CPU: the plain version against
``flash_decode_ref`` and the Pallas kernel in interpret mode on the TPU
sweep, and ``decode_attention`` against the reference's (both routes),
GQA groups of 1 to 6 and the padded query heads of a head count that
does not divide.  Tolerance rtol = atol = 2e-5, the TPU test's own
(only the fp32 summation order differs).  A row of length 0 gives zeros.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode_pallas
from repro.kernels.flash_decode.ops import decode_attention as jax_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_decode import (decode_attention,
                                              flash_decode_cuda,
                                              flash_decode_ref, launches,
                                              plan)
from repro_torch.kernels.flash_decode import kernel as FD

#: tests/kernels/test_kernels.py::TestFlashDecode (bh, s, d, block_s)
SWEEP = [(4, 64, 32, 16), (8, 1024, 128, 256), (3, 100, 64, 64),
         (16, 333, 16, 128)]
TOL = dict(rtol=2e-5, atol=2e-5)


def sweep_inputs(bh, s, d):
    r = np.random.default_rng(bh * s)
    q = r.standard_normal((bh, d)).astype(np.float32)
    k = r.standard_normal((bh, s, d)).astype(np.float32)
    v = r.standard_normal((bh, s, d)).astype(np.float32)
    lengths = r.integers(1, s + 1, bh).astype(np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("bh,s,d,bs", SWEEP)
def test_plain_version_matches_reference_and_pallas(bh, s, d, bs):
    q, k, v, lengths = sweep_inputs(bh, s, d)
    got = flash_decode_ref(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
    assert got.dtype == torch.float32 and got.shape == (bh, d)
    want = jax_ref(*(jnp.asarray(x) for x in (q, k, v, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = flash_decode_pallas(*(jnp.asarray(x) for x in (q, k, v, lengths)),
                                 block_bh=4, block_s=bs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("d", [16, 128])
def test_plain_version_in_bfloat16(d):
    """bf16 in, fp32 inside, bf16 out: within 1e-2 of the fp32 result
    on the same bf16 inputs (the card's bf16 check)."""
    q, k, v, lengths = (torch.from_numpy(x) for x in sweep_inputs(6, 200, d))
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    got = flash_decode_ref(q16, k16, v16, lengths)
    assert got.dtype == torch.bfloat16
    want = jax_ref(*(jnp.asarray(x.float().numpy()) for x in (q16, k16, v16)),
                   jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


def gqa_inputs(b, h, kvh, s, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = r.standard_normal((b, s, kvh, d)).astype(np.float32)
    lengths = r.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("b,h,kvh,s,d", [
    (2, 8, 2, 64, 32),       # the reference's test_gqa_wrapper
    (3, 12, 2, 150, 128),    # qwen2-1.5b's group of 6 at tp = 1
    (2, 4, 4, 40, 16),       # one query head per KV head
    (1, 3, 1, 77, 64),       # one KV head for all
])
def test_decode_attention_matches_reference(b, h, kvh, s, d):
    q, k, v, lengths = gqa_inputs(b, h, kvh, s, d, b * h + s)
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
    assert got.shape == (b, h, d)
    args = [jnp.asarray(x) for x in (q, k, v, lengths)]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_decode(*args, use_kernel=False)),
                               **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_decode(*args, use_kernel=True,
                                           interpret=True, block_bh=4,
                                           block_s=32)), **TOL)


def test_decode_attention_with_padded_query_heads():
    """A head count that does not divide (5 query heads over 3 KV heads,
    as ``gqa_decode`` meets it): q is zero-padded to 3 x ceil(5 / 3) = 6
    heads, the same padding the reference's ``gqa_decode`` applies."""
    q, k, v, lengths = gqa_inputs(2, 5, 3, 48, 16, 9)
    qp = np.concatenate([q, np.zeros((2, 1, 16), np.float32)], axis=1)
    got = decode_attention(*(torch.from_numpy(x) for x in (qp, k, v, lengths)))
    want = jax_decode(*(jnp.asarray(x) for x in (qp, k, v, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="do not divide"):
        decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lengths)))


def test_length_zero_gives_zeros():
    """The port's contract at length 0 is zeros (``acc / max(l, 1e-30)``
    with nothing accumulated).  The reference disagrees with itself
    there: ``flash_decode_ref`` gives NaN and the Pallas kernel the mean
    of the block-padded V rows (ROADMAP queue 3)."""
    q, k, v, lengths = sweep_inputs(4, 40, 16)
    lengths[[0, 3]] = 0
    got = flash_decode_ref(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
    assert not got[[0, 3]].any()
    assert torch.isfinite(got).all()
    want = jax_ref(*(jnp.asarray(x) for x in (q, k, v, lengths)))
    np.testing.assert_allclose(got.numpy()[1:3], np.asarray(want)[1:3], **TOL)
    assert np.isnan(np.asarray(want)[[0, 3]]).all()
    pallas = np.asarray(flash_decode_pallas(
        *(jnp.asarray(x) for x in (q, k, v, lengths)), block_bh=4,
        block_s=16, interpret=True))
    np.testing.assert_allclose(pallas[0], v[0].sum(axis=0) / 48, **TOL)
    b = decode_attention(torch.from_numpy(q[:2, None]),
                         torch.from_numpy(k[:2, :, None]),
                         torch.from_numpy(v[:2, :, None]),
                         torch.tensor([0, 7], dtype=torch.int32))
    assert not b[0].any() and b[1].any()


def test_no_fallback_off_the_cpu():
    """The kernel wrapper takes CUDA tensors only; the ops give a dry
    run's meta tensors empty outputs of the right shapes and dtypes
    (the LSE too) and launch nothing; nothing is built."""
    q, k, v, lengths = (torch.from_numpy(x)
                        for x in gqa_inputs(2, 4, 2, 32, 16, 1))
    before = launches.count
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q, k, v, lengths)
    out, lse = decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                lengths.to("meta"), return_lse=True)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                      q.dtype)
    assert (lse.shape, lse.dtype) == (q.shape[:2], torch.float32)
    assert launches.count == before
    assert "flash_decode" not in common._loaded
    path = common.library_path("flash_decode")
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("libflash_decode-")


def test_kernel_that_cannot_load_raises(monkeypatch):
    """A library that cannot be built or loaded raises out of the
    wrapper's entry, and no module of the decode path has a ``try`` that
    could turn that into the plain version."""
    def broken(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(common, "load", broken)
    with pytest.raises(RuntimeError, match="cannot load flash_decode"):
        FD._entry()
    root = os.path.dirname(os.path.dirname(FD.__file__))
    files = [os.path.join(root, "flash_decode", f)
             for f in ("kernel.py", "ops.py", "ref.py")]
    files += [os.path.join(os.path.dirname(root), "models", f)
              for f in ("attention.py", "transformer.py")]
    for path in files:
        tree = ast.parse(open(path).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("b,kvh,h,s", [(16, 2, 12, 32832), (4, 1, 1, 64),
                                       (1, 2, 12, 100), (16, 1, 1, 333),
                                       (2, 2, 32, 5000), (1, 1, 40, 70)])
def test_plan_covers_the_cache(b, kvh, h, s, d, dtype):
    """The route follows the dtype and D alone; its heads per CTA cover
    the group, its spans (multiples of TILE) cover S with no empty span,
    and the CTAs stay within a wave on the tensor cores."""
    p = plan(b, kvh, h, s, d, dtype, sms=132)
    group = h // kvh
    mma = dtype == torch.bfloat16 and d in (64, 128)
    assert p.route == ("mma" if mma else "simt")
    assert p.heads * p.n_chunks >= group > p.heads * (p.n_chunks - 1)
    if mma:
        assert p.heads == FD.MMA_HEADS
        rows = b * kvh * p.n_chunks
        assert rows * p.n_splits <= max(rows, FD.CTAS_PER_SM["mma"] * 132)
    else:
        assert p.heads in (1, 2, 4, 8) and p.heads >= min(group, 8)
        assert p.heads == 1 or p.heads // 2 < min(group, 8)
    assert p.split_len % FD.TILE[p.route] == 0
    assert p.n_splits * p.split_len >= s > (p.n_splits - 1) * p.split_len
    assert FD.cut(p.route, b, kvh, h, s, 132) == p
    if (b, kvh, h, s, d) == (16, 2, 12, 32832, 128):   # the LM main path
        assert p == (("mma", 16, 1, 4112, 8) if mma
                     else ("simt", 8, 1, 1024, 33))
