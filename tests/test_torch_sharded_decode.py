"""The sequence-sharded decode (``transformer.init_cache`` / ``prefill``
with ``mesh=``, ``decode_step`` on a placed cache,
``attention.gqa_decode_sharded`` / ``mla_decode_sharded``) and
flash_decode's LSE output, against the reference on the CPU:

* K4's plain version returns each row's log-sum-exp within 1e-5 of a
  float64 numpy logsumexp of the same masked scaled scores, ``-inf`` at
  length 0, and its outputs unchanged;
* a prefill and 4 decode steps (fixed tokens) over CPU meshes of 1, 2, 3
  and 4 entries, for GQA (the tiny config and qwen2-1.5b ``SMOKE``) and
  MLA (deepseek-v2-lite-16b ``SMOKE``), in float32 with carried weights:
  logits and the gathered cache within 1e-4 of the reference's
  ``decode_step`` and of the port's unsharded decode.  The prompt
  lengths and ``s_max`` put the written positions at 1, on a shard's
  first position and its neighbours, and at ``s_max - 1``; ``s_max``
  does not divide every shard count, and some shards lie wholly past
  every row's length;
* ``merge_by_lse`` gives zeros, not NaN, for rows no shard holds;
* phase X of ``chip_smoke.py`` on the CPU at ``SMOKE``.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.kernels.flash_decode.ref import (decode_attention_ref,
                                                  flash_decode_ref)
from repro_torch.launch.mesh import Placed, gather, make_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as tf

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bh,s,d", [(6, 40, 16), (3, 1, 32), (5, 300, 128)])
def test_plain_lse_equals_float64_logsumexp(bh, s, d):
    rng = np.random.default_rng(bh * s)
    q = rng.standard_normal((bh, d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    lengths = rng.integers(1, s + 1, bh)
    lengths[0] = 0
    lengths[-1] = s
    args = [torch.from_numpy(x) for x in (q, k, v)] + [
        torch.from_numpy(lengths)]
    out, lse = flash_decode_ref(*args, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (bh,)
    assert torch.equal(out, flash_decode_ref(*args))
    assert torch.isneginf(lse[0]) and not out[0].any()
    scores = np.einsum("bd,bsd->bs", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(d)
    for r in range(1, bh):
        row = scores[r, :lengths[r]]
        want = row.max() + np.log(np.exp(row - row.max()).sum())
        np.testing.assert_allclose(float(lse[r]), want, rtol=0, atol=1e-5)


def test_decode_attention_ref_lse_in_the_gqa_layout():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(
        np.float32)) for _ in range(2))
    lengths = torch.tensor([4, 0])
    out, lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert lse.shape == (2, 6) and torch.isneginf(lse[1]).all()
    assert torch.equal(out, decode_attention_ref(q, k, v, lengths))
    # query head h reads KV head h // 3
    s = torch.einsum("hd,hsd->hs", q[0], k[0, :4].repeat_interleave(
        3, dim=1).transpose(0, 1)) / 4.0
    torch.testing.assert_close(lse[0], torch.logsumexp(s, dim=-1))


def test_merge_by_lse_weighs_empty_shards_zero():
    o1 = torch.randn(2, 3, 4)
    o2 = torch.randn(2, 3, 4)
    l1 = torch.tensor([[0.5, 1.0, -torch.inf]] * 2)
    l2 = torch.tensor([[-torch.inf, 1.0, -torch.inf]] * 2)
    got = A.merge_by_lse([(o1, l1), (o2, l2)], torch.float32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 0], o1[:, 0])
    torch.testing.assert_close(got[:, 1], (o1[:, 1] + o2[:, 1]) / 2)
    assert not got[:, 2].any()


def tiny_kw():
    return dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, d_head=16, attn="gqa", tp=2,
                max_seq=64)


def config_pair(name):
    """(reference config, port config) in float32."""
    if name == "tiny":
        kw = tiny_kw()
        return (jtf.TransformerConfig(act_dtype=jnp.float32,
                                      param_dtype=jnp.float32, **kw),
                tf.TransformerConfig(act_dtype=torch.float32,
                                     param_dtype=torch.float32, **kw))
    mine = importlib.import_module(f"repro_torch.configs.{name}").SMOKE
    tcfg = dataclasses.replace(mine, param_dtype=torch.float32,
                               act_dtype=torch.float32)
    d = dataclasses.asdict(tcfg)
    d["param_dtype"], d["act_dtype"] = jnp.float32, jnp.float32
    return jtf.TransformerConfig(**d), tcfg


#: (prompt length, s_max) of each case, with 4 fed tokens: lengths 1 ..
#: 4 written at positions 1 .. 4 (4 shards of 10: edges at 3, 6, 9; the
#: last two shards never reached), and 9 .. 12 (4 shards of 13: 4, 4, 4,
#: 1 positions, 12 = s_max - 1 the first of the last shard; 3 shards: an
#: edge at 10).
CASES = {"from_1": (1, 10), "to_s_max": (9, 13)}
STEPS = 4
CONFIGS = ("tiny", "qwen2_1_5b", "deepseek_v2_lite_16b")


@functools.lru_cache(maxsize=None)
def reference_run(name, case):
    """The reference's prefill and decode steps on fixed tokens: (its
    params as numpy, prompt, fed tokens, logits of every step, cache)."""
    jcfg, _ = config_pair(name)
    t, s_max = CASES[case]
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(t * 31 + s_max)
    toks = rng.integers(0, jcfg.vocab, (2, t)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab, (2, STEPS)).astype(np.int32)
    _, jc = jtf.prefill(jp, jnp.asarray(toks), jcfg, s_max)
    logits = []
    for i in range(STEPS):
        lg, jc = jtf.decode_step(jp, jc, jnp.asarray(fed[:, i]), jcfg)
        logits.append(np.asarray(lg))
    return (jax.tree.map(np.asarray, jp), toks, fed, np.stack(logits),
            jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_decode_matches_reference_and_unsharded(name, case, shards):
    jp, toks, fed, want, jc = reference_run(name, case)
    _, tcfg = config_pair(name)
    t, s_max = CASES[case]
    params = tf.load_reference_params(jp, device="cpu")
    mesh = make_mesh((shards,), ("model",), ["cpu"] * shards)
    _, cache = tf.prefill(params, torch.from_numpy(toks), tcfg, s_max,
                          mesh=mesh)
    _, plain = tf.prefill(params, torch.from_numpy(toks), tcfg, s_max)
    names = tf.cache_names(tcfg)
    assert all(isinstance(cache[n], Placed) for n in names)
    seq = [bounds[2] for _, bounds, _ in cache[names[0]].blocks]
    step = -(-s_max // shards)
    assert seq == [(min(i * step, s_max), min((i + 1) * step, s_max))
                   for i in range(shards)]
    got, ref = [], []
    for i in range(STEPS):
        tok = torch.from_numpy(fed[:, i])
        lg, cache = tf.decode_step(params, cache, tok, tcfg)
        lp, plain = tf.decode_step(params, plain, tok, tcfg)
        got.append(lg)
        ref.append(lp)
    got, ref = torch.stack(got), torch.stack(ref)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, ref, **TOL)
    assert cache["lengths"].tolist() == [t + STEPS] * 2
    for n in names:
        whole = gather(cache[n])
        np.testing.assert_allclose(whole.numpy(), jc[n], **TOL)
        torch.testing.assert_close(whole, plain[n], **TOL)


def test_placed_cache_shards_are_their_own_contiguous_tensors():
    _, tcfg = config_pair("tiny")
    mesh = make_mesh((3,), ("model",), ["cpu"] * 3)
    cache = tf.init_cache(tcfg, 2, 10, device="cpu", mesh=mesh)
    k = cache["k"]
    assert tuple(k.sharding.spec) == (None, None, "model", None, None)
    assert [tuple(s.shape) for _, _, s in k.blocks] == \
        [(2, 2, 4, 2, 16), (2, 2, 4, 2, 16), (2, 2, 2, 2, 16)]
    assert all(s[0].is_contiguous() for _, _, s in k.blocks)
    assert cache["lengths"].shape == (2,) and not cache["lengths"].any()
    plain = tf.init_cache(tcfg, 2, 10, device="cpu")
    assert isinstance(plain["k"], torch.Tensor)
    unsharded = tf.init_cache(dataclasses.replace(tcfg, sharded_decode=False),
                              2, 10, device="cpu", mesh=mesh)
    assert len(unsharded["k"].shards) == 1


def test_chip_smoke_mesh_phase_on_the_cpu(monkeypatch):
    """Phase X of ``chip_smoke.py`` on the CPU, every configuration at
    ``SMOKE`` and every count cut: the sharded decodes within their
    limits and the planted plain-mean fault beyond, the float32 controls
    within 1e-4, the placed AdamW step equal to the unplaced one, DIEN's
    row-sharded tables bit for bit, the ring within G's tolerances and
    its planted fault outside; no kernel launches on the CPU."""
    import chip_smoke
    from repro_torch.configs import common as C
    from repro_torch.kernels import common
    for name in ("qwen2_7b", "deepseek_v2_236b", "dien", "equiformer_v2"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        monkeypatch.setattr(mod, "CONFIG", mod.SMOKE)
    for shape, dims in (("serve_p99", dict(batch=8)),
                        ("retrieval_cand", dict(batch=1, n_candidates=50))):
        monkeypatch.setitem(C.RECSYS_SHAPES, shape, C.ShapeSpec(
            shape, C.RECSYS_SHAPES[shape].kind, dims))
    for shape, dims in (
            ("full_graph_sm", dict(n_nodes=40, n_edges=120, d_feat=12,
                                   n_classes=5)),
            ("minibatch_lg", dict(n_nodes=500, n_edges=3000, batch_nodes=8,
                                  fanout=(3, 2), d_feat=12, n_classes=5))):
        monkeypatch.setitem(C.GNN_SHAPES, shape, C.ShapeSpec(
            shape, C.GNN_SHAPES[shape].kind, dims))
    for key, value in dict(X1_BATCH=2, X1_PROMPT=10, X1_STEPS=4, X2_BATCH=2,
                           X2_PROMPT=9, X2_STEPS=3, X3_GRAD_BATCH=8,
                           X4_REPS=2).items():
        monkeypatch.setattr(chip_smoke, key, value)
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in chip_smoke.KERNEL_SOURCES})
    out = chip_smoke.mesh_phase(counts, "the CPU", 0, device="cpu")
    for (name, n), tag in zip(out["decode"].items(), ("X1", "X2")):
        assert n["prefill_equal"] and n["shards"] == 4
        assert n["sharded"] <= chip_smoke.X_REL_TOL[tag] < \
            n["fault_plain_mean"]
        assert n["f32"]["sharded"] <= chip_smoke.X_F32_TOL
        assert n["flash_decode_launches"] == 0
    assert set(out["decode"]) == {"qwen2-7b-smoke", "deepseek-v2-236b-smoke"}
    zero = out["zero"]
    assert zero["serve_p99_equal"] and zero["retrieval_equal"]
    assert zero["adamw_max_abs_err"] <= 1e-6
    assert zero["grad_norm"][0] == pytest.approx(zero["grad_norm"][1],
                                                 rel=1e-6)
    for shape in ("full_graph_sm", "minibatch_lg"):
        ring = out["ring"][shape]
        assert ring["dropped"] == 0 and ring["max_abs_err"] < 1e-5
        assert ring["precision"] == "float64"
        assert ring["rel_l2"] <= chip_smoke.X_F32_TOL
    fault = out["ring"]["full_graph_sm"]
    assert fault["fault_column_zero_max_abs_err"] > chip_smoke.GNN_ATOL
    assert fault["fault_column_zero_rel_l2"] > chip_smoke.X_F32_TOL
    assert not any(counts.by_path["mesh"].values())


def test_chip_smoke_x_seed_readings_on_the_cpu(monkeypatch):
    """``--lm-seeds``' X1 and X2 readings on the CPU at ``SMOKE``: each
    seed's sharded decode within its X_REL_TOL and its plain-mean fault
    beyond, the readings differing from seed to seed."""
    import chip_smoke
    for name in ("qwen2_7b", "deepseek_v2_236b"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        monkeypatch.setattr(mod, "CONFIG", mod.SMOKE)
    for key, value in dict(X1_BATCH=2, X1_PROMPT=10, X1_STEPS=4, X2_BATCH=2,
                           X2_PROMPT=9, X2_STEPS=3).items():
        monkeypatch.setattr(chip_smoke, key, value)
    out = chip_smoke.x_seed_readings([0, 1], "the CPU", device="cpu")
    assert set(out) == {"X1", "X2"}
    for tag, by_seed in out.items():
        assert set(by_seed) == {0, 1}
        for n in by_seed.values():
            assert n["sharded"] <= chip_smoke.X_REL_TOL[tag] < \
                n["fault_plain_mean"]
        assert by_seed[0]["fault_plain_mean"] != \
            by_seed[1]["fault_plain_mean"]
