"""The port's MLA attention (``repro_torch.models.attention``: ``init_mla``,
``mla_train``, ``mla_prefill_blockwise``, ``mla_decode``) against the
reference on the CPU, in float32, with the reference's ``init_mla``
weights carried across and the same numpy inputs, rtol = atol = 1e-4:

* with and without q compression (``q_lora`` 0 and 24);
* the plain causal path, the blockwise path at a t that is a multiple
  of ``block_k``, and at a ragged t against the reference's *plain*
  path (the reference's own blockwise path clamps the last block's
  start there and is wrong: ROADMAP queue 3);
* the absorbed decode, step by step after a prefill: outputs and both
  cache tensors, written in place;
* the absorbed decode of the last token equals ``mla_train``'s last
  position over the same prefix (what ``chip_smoke.py``'s M-check
  holds on the card at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import transformer as jtf
from repro_torch.models import attention as A
from repro_torch.models import transformer as tf

TOL = dict(rtol=1e-4, atol=1e-4)


def cfg_pair(**kw):
    base = dict(name="mla", n_layers=1, d_model=48, n_heads=3, n_kv_heads=3,
                d_ff=64, vocab=64, d_head=16, attn="mla", kv_lora=24,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=12, tp=2)
    base.update(kw)
    return (jtf.TransformerConfig(param_dtype=jnp.float32,
                                  act_dtype=jnp.float32, **base),
            tf.TransformerConfig(param_dtype=torch.float32,
                                 act_dtype=torch.float32, **base))


def weights(jcfg, seed):
    jp, _ = JA.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jp, tf.load_reference_params(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def inputs(b, t, seed):
    x = np.random.default_rng(seed).standard_normal((b, t, 48)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    return (jnp.asarray(x), jnp.asarray(pos), torch.from_numpy(x),
            torch.from_numpy(pos.copy()))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("q_lora", [0, 24])
def test_init_mla_matches_the_reference_tree(q_lora):
    jcfg, tcfg = cfg_pair(q_lora=q_lora)
    jp, _ = JA.init_mla(jax.random.PRNGKey(0), jcfg)
    tp = A.init_mla(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", lead=(2,))
    assert set(tp) == set(jp)
    assert ("wdq" in tp) == bool(q_lora) and ("wq" in tp) != bool(q_lora)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (2,) + v.shape, k
    assert tcfg.padded_heads == 4                   # 3 heads padded at tp 2
    assert torch.equal(tp["kv_norm"], torch.ones(2, 24))


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_train_matches_reference(q_lora):
    jcfg, tcfg = cfg_pair(q_lora=q_lora)
    jp, tp = weights(jcfg, 1)
    jx, jpos, tx, tpos = inputs(2, 13, 2)
    jout, (jckv, jkr) = JA.mla_train(jp, jx, jcfg, jpos)
    out, (ckv, kr) = A.mla_train(tp, tx, tcfg, tpos)
    close(out, jout)
    close(ckv, jckv)
    close(kr, jkr)


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_prefill_blockwise_matches_reference(q_lora):
    """t = 32, block_k 8: every block whole, the reference's blockwise
    path is right and the port equals it (and the plain path)."""
    jcfg, tcfg = cfg_pair(q_lora=q_lora)
    jp, tp = weights(jcfg, 3)
    jx, jpos, tx, tpos = inputs(2, 32, 4)
    jout, (jckv, jkr) = JA.mla_prefill_blockwise(jp, jx, jcfg, jpos,
                                                 block_k=8)
    out, (ckv, kr) = A.mla_prefill_blockwise(tp, tx, tcfg, tpos, block_k=8)
    close(out, jout)
    close(ckv, jckv)
    close(kr, jkr)
    plain, _ = A.mla_train(tp, tx, tcfg, tpos)
    torch.testing.assert_close(out, plain, **TOL)


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_blockwise_prefill_at_ragged_t_matches_reference_plain_path(
        q_lora):
    """t = 20 with block_k 8: the last block holds 4 keys.  The port
    equals the reference's plain ``mla_train``; the reference's own
    ``mla_prefill_blockwise`` clamps the last block's start while its
    mask uses the unclamped one, and is wrong there."""
    jcfg, tcfg = cfg_pair(q_lora=q_lora)
    jp, tp = weights(jcfg, 5)
    jx, jpos, tx, tpos = inputs(2, 20, 6)
    jplain, _ = JA.mla_train(jp, jx, jcfg, jpos)
    out, _ = A.mla_prefill_blockwise(tp, tx, tcfg, tpos, block_k=8)
    close(out, jplain)
    jbad, _ = JA.mla_prefill_blockwise(jp, jx, jcfg, jpos, block_k=8)
    assert np.abs(np.asarray(jbad) - np.asarray(jplain)).max() > 0.1


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_decode_steps_match_reference(q_lora):
    """Four absorbed decode steps after a prefill of 6 tokens into a
    cache of 12: outputs and both cache tensors equal the reference's,
    and the port writes its cache in place."""
    jcfg, tcfg = cfg_pair(q_lora=q_lora)
    jp, tp = weights(jcfg, 7)
    b, t0, s = 2, 6, 12
    jx, jpos, tx, tpos = inputs(b, t0 + 4, 8)
    _, (jckv, jkr) = JA.mla_train(jp, jx[:, :t0], jcfg, jpos[:, :t0])
    jc1 = jnp.pad(jckv, ((0, 0), (0, s - t0), (0, 0)))
    jc2 = jnp.pad(jkr, ((0, 0), (0, s - t0), (0, 0)))
    c1, c2 = (torch.from_numpy(np.array(c)) for c in (jc1, jc2))
    store = c1
    for i in range(t0, t0 + 4):
        jlen = jnp.full((b,), i, jnp.int32)
        jout, jc1, jc2 = JA.mla_decode(jp, jx[:, i:i + 1], jc1, jc2, jlen,
                                       jcfg)
        out, c1, c2 = A.mla_decode(tp, tx[:, i:i + 1], c1, c2,
                                   torch.full((b,), i, dtype=torch.int32),
                                   tcfg)
        close(out, jout)
        close(c1, jc1)
        close(c2, jc2)
        assert c1 is store


def test_mla_decode_equals_train_over_the_same_prefix():
    """The absorbed decode of token t over a cache of the first t tokens
    gives ``mla_train``'s output at position t (W_uk and W_uv absorbed
    change only the order of the products)."""
    _, tcfg = cfg_pair(q_lora=24)
    _, tp = weights(cfg_pair(q_lora=24)[0], 9)
    _, _, tx, tpos = inputs(3, 11, 10)
    full, (ckv, kr) = A.mla_train(tp, tx, tcfg, tpos)
    c1 = torch.zeros(3, 16, 24)
    c2 = torch.zeros(3, 16, 8)
    c1[:, :10], c2[:, :10] = ckv[:, :10], kr[:, :10]
    out, _, _ = A.mla_decode(tp, tx[:, 10:], c1, c2,
                             torch.full((3,), 10, dtype=torch.int32), tcfg)
    torch.testing.assert_close(out[:, 0], full[:, 10], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c1[:, :11], ckv, rtol=1e-6, atol=1e-6)
