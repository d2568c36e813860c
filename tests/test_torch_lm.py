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
* the ``SMOKE`` of every LM configuration (qwen2-1.5b, qwen2-7b,
  phi3-medium-14b, deepseek-v2-lite-16b, deepseek-v2-236b): prefill and
  several decode steps, logits and caches within 1e-4;
* in bfloat16 at 28 layers, decode logits within ``chip_smoke.py``'s L4
  limit of a prefill of the same tokens (the reference's are not);
* RoPE tables in float64, as the reference's (x64 on);
* the configurations and the registry equal to the reference's
  (parameter counts, padded heads and vocabulary included), ``dien``
  resolving to the reference's id and an unknown id raising
  ``KeyError``;
* ``chip_smoke.py``'s M-check helpers at ``SMOKE``: with the no-drop
  capacity factor decode agrees with a prefill of the same tokens far
  inside the M-check limit, the planted fault (the rope term left out
  of the decode scores) misses it, the absorbed decode equals
  ``mla_train`` over the same prefix, and the drop share of a prefill
  is counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

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
    for name in set(tc) - {"lengths"}:
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


LM_MODULES = ("qwen2_1_5b", "qwen2_7b", "phi3_medium_14b",
              "deepseek_v2_lite_16b", "deepseek_v2_236b")


def config_modules(name):
    return (importlib.import_module(f"repro_torch.configs.{name}"),
            importlib.import_module(f"repro.configs.{name}"))


def check_smoke(module):
    """A configuration's ``SMOKE`` in float32: prefill of 16 tokens,
    then 4 decode steps, logits and caches within 1e-4 (the MoE ones
    route at the default capacity factor, which drops)."""
    mine, _ = config_modules(module)
    tcfg = dataclasses.replace(mine.SMOKE, param_dtype=torch.float32,
                               act_dtype=torch.float32)
    jcfg = to_jax(tcfg)
    jp, tp = params_pair(jcfg, 5)
    toks = tokens((3, 20), tcfg.vocab, 3)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :16]), jcfg, 24)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks[:, :16]), tcfg, 24)
    assert set(tc) == set(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(jc, tc)
    for i in range(16, 20):
        jl, jc = jtf.decode_step(jp, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tf.decode_step(tp, tc, torch.from_numpy(toks[:, i]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_cache_close(jc, tc)


def test_qwen2_smoke_prefill_and_decode_match_reference():
    check_smoke("qwen2_1_5b")


@pytest.mark.parametrize("module", LM_MODULES[1:])
def test_smoke_prefill_and_decode_match_reference(module):
    """The other four LM configurations' ``SMOKE`` (:func:`check_smoke`)."""
    check_smoke(module)


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
    """The five LM configurations (``CONFIG`` and ``SMOKE``) equal the
    reference's, with its parameter counts, padded heads and vocabulary;
    the registry serves them, and every other ported id (the GNNs
    ``egnn``, ``nequip`` and ``equiformer-v2`` among them), with the
    reference's specs; ``dien`` resolves to the reference's id, and
    every id of the reference's registry is ported."""
    for module in LM_MODULES:
        mine, ref = config_modules(module)
        for cfg, rcfg in ((mine.CONFIG, ref.CONFIG),
                          (mine.SMOKE, ref.SMOKE)):
            assert dataclasses.asdict(to_jax(cfg)) == \
                dataclasses.asdict(rcfg)
            assert cfg.param_dtype == torch.bfloat16
            assert (cfg.padded_heads, cfg.padded_vocab, cfg.param_count(),
                    cfg.active_param_count()) == \
                (rcfg.padded_heads, rcfg.padded_vocab, rcfg.param_count(),
                 rcfg.active_param_count())
        spec = mine.SPEC
        assert (spec.config, spec.smoke) == (mine.CONFIG, mine.SMOKE)
        assert configs.get(spec.arch_id) is spec
        on_card = dataclasses.replace(mine.CONFIG, tp=1)
        assert on_card.padded_heads == mine.CONFIG.n_heads
        assert on_card.padded_vocab == mine.CONFIG.vocab
    for arch in configs.ARCH_IDS:
        mine_spec, ref_spec = configs.get(arch), jax_get(arch)
        assert (mine_spec.arch_id, mine_spec.family, mine_spec.source) == \
            (ref_spec.arch_id, ref_spec.family, ref_spec.source)
        assert {k: dataclasses.asdict(s)
                for k, s in mine_spec.shapes.items()} == \
            {k: dataclasses.asdict(s) for k, s in ref_spec.shapes.items()}
    assert set(configs.ARCH_IDS) == {
        "dspc", "pna", "egnn", "nequip", "equiformer-v2", "qwen2-1.5b",
        "qwen2-7b", "phi3-medium-14b", "deepseek-v2-lite-16b",
        "deepseek-v2-236b", "dien"}
    from repro.configs import ARCH_IDS as JAX_IDS
    assert configs.ARCH_IDS == JAX_IDS
    for arch in ("egnn", "nequip", "equiformer-v2"):
        assert configs.get(arch).arch_id == jax_get(arch).arch_id == arch
    assert configs.get("dien").arch_id == jax_get("dien").arch_id == "dien"
    assert configs.get("dien").family == "recsys"


def test_published_sizes_of_the_new_configs():
    """The numbers ``chip_smoke.py`` and PERF.md quote: deepseek-v2-lite
    16.21 B parameters (32.4 GB in bf16), deepseek-v2 239 B, an MLA
    cache of 31104 B a token over 27 layers, and phi3's 48 padded heads
    at the reference's tp = 16 (a decode group of 5 over 10 KV heads)."""
    lite, big = (config_modules(m)[0].CONFIG
                 for m in ("deepseek_v2_lite_16b", "deepseek_v2_236b"))
    assert lite.param_count() == 16_210_309_120
    assert round(big.param_count() / 1e9) == 239
    assert lite.n_layers * (lite.kv_lora + lite.qk_rope_dim) * 2 == 31104
    phi3 = config_modules("phi3_medium_14b")[0].CONFIG
    assert phi3.padded_heads == 48 and -(-48 // phi3.n_kv_heads) == 5


def test_unported_configs_and_missing_card_raise():
    """An id neither package knows raises ``KeyError`` (the recsys
    ``dien`` resolves now); MLA and MoE configurations build on the CPU
    when asked, in the reference's tree (the router in float32) and
    bytes; without a card every entry point raises."""
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        configs.get("no-such-arch")
    with pytest.raises(KeyError):
        jax_get("no-such-arch")
    assert configs.get("dien").arch_id == "dien"
    gen = torch.Generator().manual_seed(0)
    mine, _ = config_modules("deepseek_v2_236b")
    for cfg in (tf.TransformerConfig(**tiny_kw()), mine.SMOKE):
        p = tf.init_params(cfg, generator=gen, device="cpu")
        ref = jtf.init_params(to_jax(cfg), jax.random.PRNGKey(0))
        leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in leaves:
            got = p
            for key in path:
                got = got[key.key]
            assert tuple(got.shape) == leaf.shape
            assert got.element_size() == leaf.dtype.itemsize, path
        assert tf.param_bytes(p) == sum(x.nbytes for _, x in leaves)
        cache = tf.init_cache(cfg, 2, 8, device="cpu")
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: v.shape for k, v in jtf.abstract_cache(
                to_jax(cfg), 2, 8).items()}
    assert p["layers"]["ffn"]["router"].dtype == torch.float32
    assert p["layers"]["attn"]["wuq"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        for call in (lambda: tf.init_params(cfg),
                     lambda: tf.init_cache(cfg, 1, 8),
                     lambda: A.init_gqa(cfg, generator=gen),
                     lambda: A.init_mla(cfg, generator=gen),
                     lambda: M.init_moe(cfg, generator=gen),
                     lambda: M.init_dense_ffn(8, 16, generator=gen),
                     lambda: init_rms(8),
                     lambda: tf.load_reference_params({"w": np.zeros(2)})):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_chip_smoke_mla_moe_check_helpers_at_smoke():
    """``chip_smoke.py``'s M-check at deepseek-v2-236b ``SMOKE`` on the
    CPU: the no-drop factor e / k leaves no assignment dropped, decode
    agrees with a prefill of the same tokens and the absorbed decode
    with ``mla_train`` far inside the limit, the planted fault (the rope
    term left out of the decode scores) misses it; at the default
    capacity factor a prefill drops and the counter says how many."""
    import chip_smoke
    mine, _ = config_modules("deepseek_v2_236b")
    params = tf.init_params(mine.SMOKE, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    prompts = torch.from_numpy(tokens((2, 12), mine.SMOKE.vocab, 7))
    drops = chip_smoke.DropCount()
    with drops.watch():
        tf.prefill(params, prompts, mine.SMOKE, 16)
    assert drops.share() > 0                  # capacity 1.25 drops here
    small = chip_smoke.float32_layers(params, 2)
    assert small["layers"]["ffn"]["w_gate"].dtype == torch.float32
    cfg = chip_smoke.no_drop_float32(mine.SMOKE, 2)
    assert cfg.moe_capacity_factor == 4.0 and cfg.n_layers == 2
    drops = chip_smoke.DropCount()
    with drops.watch():
        out = chip_smoke.mla_moe_check(small, cfg, prompts, 4)
    assert drops.dropped == 0 and drops.assigned > 0
    assert out["decode"] < 1e-5 and out["absorbed"] < 1e-5
    assert out["no_rope"] > 100 * chip_smoke.MCHECK_REL_TOL
    assert out["argmax"] == 2


def test_chip_smoke_lm_family_phases_on_the_cpu(monkeypatch):
    """Phases M, M-check, M2 and M3 of ``chip_smoke.py`` end to end on
    the CPU, every configuration at its ``SMOKE`` (bfloat16) and every
    count cut: each check of the phases holds, and the numbers carry
    the drop share, the M-check readings and K4's rows (the CPU route
    launches no kernel)."""
    import chip_smoke
    from repro_torch.configs import common as C
    from repro_torch.kernels import common
    for name in LM_MODULES[1:]:
        mod = config_modules(name)[0]
        monkeypatch.setattr(mod, "CONFIG", mod.SMOKE)
    monkeypatch.setitem(C.LM_SHAPES, "decode_32k", C.ShapeSpec(
        "decode_32k", "decode", dict(seq_len=24, global_batch=128)))
    for key, value in dict(DS_BATCH=2, DS_GROUP=1, DS_STEPS=3,
                           LM_TRACE_STEPS=2, MCHECK_BATCH=2,
                           MCHECK_PROMPT=12, MCHECK_STEPS=3,
                           MCHECK_PREFIX=8, M2_BATCH=2, M2_PROMPT=10,
                           M2_STEPS=3, M3_BATCH=2, M3_PROMPT=10, M3_STEPS=3,
                           FD_FAMILY_BATCH=2, FD_GROUP5_ROWS=1,
                           FD_REPS=1).items():
        monkeypatch.setattr(chip_smoke, key, value)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=3:
                        fn() is None or 1.0)
    monkeypatch.setattr(chip_smoke, "device_trace",
                        lambda fn, per=1, expect=None: (None, None, {}))
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in ("spc_query", "segment_matmul",
                                              "embedding_bag",
                                              "flash_decode")})
    out = chip_smoke.deepseek_phases(counts, "the CPU", 0, device="cpu")
    out.update(chip_smoke.dense_family_phase(counts, "the CPU", 0, 132,
                                             device="cpu"))
    assert set(out) == {"deepseek-v2-lite-16b", "deepseek-v2-236b",
                        "qwen2-7b", "phi3-medium-14b"}
    lite = out["deepseek-v2-lite-16b"]
    assert lite["requests"] == 2 and lite["prompt"] == 24
    assert 0 < lite["prefill_drop_share"] < 1
    assert lite["check"]["decode"] <= chip_smoke.MCHECK_REL_TOL < \
        lite["check"]["no_rope"]
    assert out["deepseek-v2-236b"]["check"]["absorbed"] <= \
        chip_smoke.MCHECK_REL_TOL
    rep = out["deepseek-v2-236b"]["moe_repeat"]
    assert rep["port"]["repeats"] and rep["port"]["differing"] == 0
    assert set(rep["scatter_add"]) == {"repeats", "differing", "elements"}
    for name in ("qwen2-7b", "phi3-medium-14b"):
        row = out[name]["flash_decode"]
        assert row["launches"] == 0 and row["shape"]["S"] == 24
        assert set(row) >= {"ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err", "served_max_abs_err"}
        served = out[name]["flash_decode_served"]
        assert served["shape"][:2] == [2, row["shape"]["H"]]
        assert served["shape"][3] == 10 + 3           # prompt + steps
        assert row["served_max_abs_err"] == max(served["served"],
                                                served["ragged"]) < 1e-2
    assert "group5_max_abs_err" in out["phi3-medium-14b"]["flash_decode"]
    assert not any(counts.of(k)[0] for k in counts.counters)
