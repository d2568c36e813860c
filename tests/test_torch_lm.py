"""The port's LM serving path (``repro_torch.models.transformer``,
``attention``, ``moe``, ``common``; ``repro_torch.configs``) against the
reference on the CPU, in float32, with the reference's parameters
carried across (``load_reference_params``):

* ``prefill`` logits and caches at the ``tests/models/test_lm.py`` tiny
  config, on the plain and the blockwise route (t a multiple of
  ``block_k``), rtol = atol = 1e-4;
* four ``decode_step``s after a prefill, logits and caches, 1e-4;
* the port's blockwise prefill at a ragged t (40, block_k 16) equal to
  the reference's plain path, 2e-4 (the reference's own blockwise path
  is wrong there: ROADMAP queue 3);
* decode with a query-head count that does not divide the KV heads;
* qwen2-1.5b ``SMOKE`` prefill + decode;
* in bfloat16 at 28 layers, decode logits within ``chip_smoke.py``'s L4
  limit of a prefill of the same tokens (the reference's are not);
* RoPE tables in float64, as the reference's (x64 on);
* the configurations and the registry equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs.qwen2_1_5b import CONFIG as JAX_CONFIG
from repro.configs.qwen2_1_5b import SMOKE as JAX_SMOKE
from repro.models import attention as JA
from repro.models import transformer as jtf
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch import configs
from repro_torch.configs.qwen2_1_5b import CONFIG, SMOKE
from repro_torch.models import attention as A
from repro_torch.models import transformer as tf
from repro_torch.models import moe as M
from repro_torch.models.common import init_rms, linear, rms_norm, swiglu
from repro_torch.models.moe import dense_ffn

TOL = dict(rtol=1e-4, atol=1e-4)
_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def tiny_kw(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, d_head=16, attn="gqa", tp=2,
                max_seq=64)
    base.update(kw)
    return base


def pair(**kw):
    """The same float32 configuration in both packages."""
    return (jtf.TransformerConfig(act_dtype=jnp.float32,
                                  param_dtype=jnp.float32, **kw),
            tf.TransformerConfig(act_dtype=torch.float32,
                                 param_dtype=torch.float32, **kw))


def to_jax(cfg):
    """The reference's config of a port config (dtypes translated)."""
    d = dataclasses.asdict(cfg)
    d["param_dtype"] = _DTYPES[cfg.param_dtype]
    d["act_dtype"] = _DTYPES[cfg.act_dtype]
    return jtf.TransformerConfig(**d)


def params_pair(jcfg, seed):
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tf.load_reference_params(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def assert_cache_close(jc, tc, tol=TOL):
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **tol)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_load_reference_params_round_trip():
    jcfg, _ = pair(**tiny_kw(qkv_bias=True))
    jp, tp = params_pair(jcfg, 0)
    jl, tl = jax.tree_util.tree_flatten_with_path(jp)[0], []

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            tl.append((path, t))
    walk(tp)
    assert [tuple(p.key for p in path) for path, _ in jl] == \
        [path for path, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert b.dtype == torch.float32 and b.shape == a.shape
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tp["layers"]["attn"]["wq"].shape == (2, 64, 64)   # [L, in, out]
    # bfloat16 leaves (the reference's default dtype) carry bit for bit
    bf = jtf.init_params(JAX_SMOKE, jax.random.PRNGKey(1))
    got = tf.load_reference_params(jax.tree.map(np.asarray, bf), device="cpu")
    want = np.asarray(bf["embed"]).view(np.uint16)
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].view(torch.int16).numpy()
                                  .view(np.uint16), want)


@pytest.mark.parametrize("route", ["plain", "blockwise"])
def test_prefill_matches_reference(route):
    kw = tiny_kw(qkv_bias=True)
    if route == "blockwise":
        kw.update(blockwise_prefill_from=1, prefill_block_k=16)
    jcfg, tcfg = pair(**kw)
    jp, tp = params_pair(jcfg, 1)
    toks = tokens((2, 64), 256, 0)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks), jcfg, 72)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks), tcfg, 72)
    assert tl.shape == (2, tcfg.padded_vocab)
    assert tc["k"].shape == (2, 2, 72, 2, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(jc, tc)


def test_decode_steps_match_reference():
    jcfg, tcfg = pair(**tiny_kw())
    jp, tp = params_pair(jcfg, 2)
    toks = tokens((2, 12), 256, 1)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :8]), jcfg, 16)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks[:, :8]), tcfg, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    k_store = tc["k"]
    for i in range(8, 12):
        jl, jc = jtf.decode_step(jp, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tf.decode_step(tp, tc, torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_cache_close(jc, tc)
        assert tc["k"] is k_store        # written in place, not copied
    assert tc["lengths"].tolist() == [12, 12]


def test_blockwise_prefill_at_ragged_t_matches_reference_plain_path():
    """t = 40 with block_k = 16: the last block holds 8 keys.  The port
    equals the reference's plain causal path; the reference's own
    blockwise path clamps the last block's start and is wrong there."""
    plain_kw = tiny_kw(blockwise_prefill_from=1 << 30)
    block_kw = tiny_kw(blockwise_prefill_from=1, prefill_block_k=16)
    jplain, _ = pair(**plain_kw)
    jblock, tblock = pair(**block_kw)
    jp, tp = params_pair(jplain, 1)
    toks = tokens((2, 40), 256, 0)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks), jplain, 48)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks), tblock, 48)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert_cache_close(jc, tc, tol)
    jbad, _ = jtf.prefill(jp, jnp.asarray(toks), jblock, 48)
    assert np.abs(np.asarray(jbad) - np.asarray(jl)).max() > 1.0   # 2.79


def test_blockwise_attention_skips_no_arithmetic():
    """Rows whose queries all precede a key block are left out of it and
    no number changes: the result equals the plain causal softmax at a t
    that is not a multiple of block_k, also where positions repeat and
    where a whole block precedes every query."""
    r = np.random.default_rng(4)
    b, h, t, dh = 2, 3, 37, 8
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for s in ((b, h, t, dh), (b, t, h, dh), (b, t, h, dh)))

    def blk(start):
        return k[:, start:start + 8], v[:, start:start + 8]

    kpos = torch.arange(t)
    for pos in (torch.arange(t), torch.sort(torch.from_numpy(
            r.integers(0, t, t))).values, torch.arange(t) // 2):
        got = A.blockwise_attention(q, blk, t, 8, 0.3,
                                    pos.to(torch.int32).expand(b, t))
        scores = torch.einsum("bhtd,bshd->bhts", q, k) * 0.3
        scores = scores.masked_fill(pos[:, None] < kpos, float("-inf"))
        want = torch.einsum("bhts,bshd->bhtd", scores.softmax(-1), v)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_decode_agrees_with_prefill_where_the_reference_drifts():
    """chip_smoke.py's L4 at 28 bfloat16 layers (narrow widths, t a
    multiple of block_k): the port's decode logits stay within L4's
    relative L2 limit of a prefill of the same tokens, because its
    decode attention computes scores and probabilities in float32.  The
    reference's decode rounds both to bfloat16 and misses that limit."""
    import chip_smoke
    kw = dict(name="d", n_layers=28, d_model=256, n_heads=12, n_kv_heads=2,
              d_ff=512, vocab=1024, d_head=32, attn="gqa", qkv_bias=True,
              tp=1, blockwise_prefill_from=64, prefill_block_k=32)
    jcfg, tcfg = jtf.TransformerConfig(**kw), tf.TransformerConfig(**kw)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tf.load_reference_params(jax.tree.map(np.asarray, jp), device="cpu")
    prompts, steps = tokens((2, 88), 1024, 0), 8
    s_max = 88 + steps
    jl, jc = jtf.prefill(jp, jnp.asarray(prompts), jcfg, s_max)
    tok, fed = jnp.argmax(jl, -1).astype(jnp.int32), []
    for _ in range(steps):
        fed.append(tok)
        jl, jc = jtf.decode_step(jp, jc, tok, jcfg)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    full = jnp.concatenate([jnp.asarray(prompts), jnp.stack(fed, 1)], 1)
    want, _ = jtf.prefill(jp, full, jcfg, s_max)
    a, b = np.asarray(jl, np.float32), np.asarray(want, np.float32)
    ref_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    tl, tc = tf.prefill(tp, torch.from_numpy(prompts), tcfg, s_max)
    fed_t, last, tc, _ = chip_smoke.greedy_decode(
        tp, tcfg, tc, tl.argmax(-1).to(torch.int32), steps)
    rel, _, _ = chip_smoke.decode_consistency(tp, tcfg,
                                              torch.from_numpy(prompts),
                                           fed_t, last, s_max)
    assert rel <= chip_smoke.LM_REL_TOL < ref_rel, (rel, ref_rel)

def test_nondivisible_heads_decode_matches_reference():
    """phi3-style: 5 heads padded to 6 (tp 2), 3 KV heads."""
    jcfg, tcfg = pair(**tiny_kw(n_heads=5, n_kv_heads=3, tp=2))
    assert tcfg.padded_heads == 6
    jp, tp = params_pair(jcfg, 3)
    toks = tokens((2, 9), 256, 2)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :6]), jcfg, 12)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks[:, :6]), tcfg, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(6, 9):
        jl, jc = jtf.decode_step(jp, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tf.decode_step(tp, tc, torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_cache_close(jc, tc)
    # the reference test's start: a zero cache at length 4
    jc = jtf.init_cache(jcfg, 2, 16)
    jc["lengths"] = jnp.full((2,), 4, jnp.int32)
    tc = tf.init_cache(tcfg, 2, 16, device="cpu")
    tc["lengths"].fill_(4)
    jl, jc = jtf.decode_step(jp, jc, jnp.asarray([1, 2], jnp.int32), jcfg)
    tl, tc = tf.decode_step(tp, tc, torch.tensor([1, 2]), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["lengths"].tolist() == [5, 5]


def test_qwen2_smoke_prefill_and_decode_match_reference():
    tcfg = dataclasses.replace(SMOKE, param_dtype=torch.float32,
                               act_dtype=torch.float32)
    jcfg = to_jax(tcfg)
    jp, tp = params_pair(jcfg, 5)
    toks = tokens((3, 20), SMOKE.vocab, 3)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :16]), jcfg, 24)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks[:, :16]), tcfg, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(jc, tc)
    for i in range(16, 20):
        jl, jc = jtf.decode_step(jp, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tf.decode_step(tp, tc, torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_cache_close(jc, tc)


def test_rope_tables_are_float64_like_the_reference():
    pos = np.arange(0, 40000, 997, dtype=np.int32)[None]
    jcos, jsin = JA.rope_tables(jnp.asarray(pos), 128, 10000.0)
    assert jcos.dtype == jnp.float64
    cos, sin = A.rope_tables(torch.from_numpy(pos), 128, 10000.0)
    assert cos.dtype == torch.float64 and cos.shape == (1, pos.shape[1], 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-12)
    x = np.random.default_rng(0).standard_normal(
        (1, pos.shape[1], 2, 128)).astype(np.float32)
    got = A.apply_rope(torch.from_numpy(x), cos[:, :, None], sin[:, :, None])
    want = JA.apply_rope(jnp.asarray(x), jcos[:, :, None], jsin[:, :, None])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_blocks_match_reference():
    r = np.random.default_rng(6)
    x = r.standard_normal((3, 5, 32)).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(g), torch.from_numpy(x)).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(g), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert rms_norm(torch.from_numpy(g), xb).dtype == torch.bfloat16
    w = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32))
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    xt = torch.from_numpy(x)
    want = torch.nn.functional.silu(xt @ w["w_gate"]) * (xt @ w["w_up"])
    torch.testing.assert_close(dense_ffn(w, xt), want @ w["w_down"])
    torch.testing.assert_close(swiglu(xt, xt), torch.nn.functional.silu(xt)
                               * xt)
    lin = {"w": w["w_gate"], "b": torch.ones(48)}
    torch.testing.assert_close(linear(lin, xt), xt @ w["w_gate"] + 1)


def test_configs_and_registry_match_reference():
    for mine, ref in ((CONFIG, JAX_CONFIG), (SMOKE, JAX_SMOKE)):
        assert dataclasses.asdict(to_jax(mine)) == dataclasses.asdict(ref)
        assert mine.param_dtype == torch.bfloat16
        assert (mine.padded_heads, mine.padded_vocab, mine.param_count()) == \
            (ref.padded_heads, ref.padded_vocab, ref.param_count())
    on_card = dataclasses.replace(CONFIG, tp=1)
    assert on_card.padded_heads == 12 and on_card.padded_vocab == 151936
    for arch in configs.ARCH_IDS:
        mine, ref = configs.get(arch), jax_get(arch)
        assert (mine.arch_id, mine.family, mine.source) == \
            (ref.arch_id, ref.family, ref.source)
        assert {k: dataclasses.asdict(s) for k, s in mine.shapes.items()} == \
            {k: dataclasses.asdict(s) for k, s in ref.shapes.items()}
    assert set(configs.ARCH_IDS) == {"dspc", "pna", "qwen2-1.5b"}
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get("qwen2-7b")


def test_unported_configs_and_missing_card_raise():
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(attn="mla"), dict(moe_experts=4, moe_top_k=2,
                                      moe_d_ff=32)):
        cfg = tf.TransformerConfig(**tiny_kw(**kw))
        with pytest.raises(NotImplementedError):
            tf.init_params(cfg, generator=gen, device="cpu")
        with pytest.raises(NotImplementedError):
            tf.init_cache(cfg, 1, 8, device="cpu")
    cfg = tf.TransformerConfig(**tiny_kw())
    p = tf.init_params(cfg, generator=gen, device="cpu")
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tf.param_bytes(p) == 2 * sum(
        x.size for x in jax.tree.leaves(jtf.init_params(
            to_jax(cfg), jax.random.PRNGKey(0))))
    if not torch.cuda.is_available():
        for call in (lambda: tf.init_params(cfg),
                     lambda: tf.init_cache(cfg, 1, 8),
                     lambda: A.init_gqa(cfg, generator=gen),
                     lambda: M.init_dense_ffn(8, 16, generator=gen),
                     lambda: init_rms(8),
                     lambda: tf.load_reference_params({"w": np.zeros(2)})):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
