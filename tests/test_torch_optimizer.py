"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``) on the CPU, on the same trees
(carried across with ``load_tree`` / ``load_reference_state``):

* ``apply`` over several steps (the warmup, then the cosine), with and
  without ``compress``, on a tree of float32 and bfloat16 leaves with
  gradients large enough to clip: float32 parameters, moments and
  residuals within rtol 1e-6 and an atol of 1e-6 times the leaf's
  largest magnitude (where b1 m and (1 - b1) g cancel, an element keeps
  an absolute error of an ulp of its terms; a residual, the gradient
  less its int8 value, within 1e-6 times its leaf's largest clipped
  gradient), bfloat16 parameters within one bfloat16 ulp, ``step`` equal, the stats (``grad_norm``, ``lr``) within 1e-6;
* ``schedule``, ``global_norm`` and the int8 error-feedback round trip
  (``_compress_decompress``, half-to-even rounding) within 1e-6;
* ``init``'s tree: float32 moments, 0-d residuals unless ``compress``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.models.common import load_tree
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import flatten

TOL = dict(rtol=1e-6, atol=1e-12)
CFG = O.AdamWConfig(warmup_steps=3, total_steps=12)


def trees(seed: int, scale: float = 1.0):
    """(params, grads) as numpy trees: float32 and bfloat16 leaves."""
    rng = np.random.default_rng(seed)

    def draw(shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)
    params = {"w": draw((6, 5)), "b": draw((5,)),
              "layers": [{"k": draw((3, 4))}, {"k": draw((3, 4))}],
              "half": draw((7, 3))}
    grads = jax.tree.map(lambda x: draw(x.shape, scale), params)
    return params, grads


def as_jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(x).astype(
            jnp.bfloat16 if "half" in jax.tree_util.keystr(p) else
            jnp.float32), tree)


def assert_tree_close(got, want, scales=None):
    """``got`` within the module doc's tolerances of ``want``; ``scales``
    (a tree like it) sets each float32 leaf's absolute floor in place of
    its own largest magnitude."""
    mine, td = flatten(got)
    ref = jax.tree.leaves(want)
    floors = ([None] * len(ref) if scales is None else
              [float(np.abs(np.asarray(x, np.float32)).max())
               for x in jax.tree.leaves(scales)])
    assert len(mine) == len(ref)
    for a, w, floor in zip(mine, ref, floors):
        if w.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            ulp = np.abs(np.asarray(w.astype(jnp.float32))) * 2.0 ** -7
            diff = np.abs(a.float().numpy() - np.asarray(w.astype(
                jnp.float32)))
            assert (diff <= ulp + 1e-30).all()
        else:
            assert a.dtype == torch.float32, a.dtype
            w = np.asarray(w)
            floor = float(np.abs(w).max()) if floor is None else floor
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * floor)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["small", "clipped"])
def test_apply_matches_reference_over_steps(compress, scale):
    cfg = dataclasses.replace(CFG, compress=compress)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(cfg))
    params, _ = trees(0)
    jp = as_jax(params)
    tp = load_tree(jax.tree.map(np.asarray, jp), device="cpu")
    js, ts = JO.init(jp, jcfg), O.init(tp, cfg)
    for step in range(6):
        _, grads = trees(step + 1, scale)
        jg = as_jax(grads)
        tg = load_tree(jax.tree.map(np.asarray, jg), device="cpu")
        jp, js, jstats = JO.apply(jp, jg, js, jcfg)
        tp, ts, tstats = O.apply(tp, tg, ts, cfg)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for name in ("grad_norm", "lr"):
            assert tstats[name].dtype == torch.float32
            np.testing.assert_allclose(float(tstats[name]),
                                       float(jstats[name]), rtol=1e-6)
        assert_tree_close(tp, jp)
        for part in ("mu", "nu"):
            assert_tree_close(getattr(ts, part), getattr(js, part))
        clip = min(1.0, cfg.grad_clip / (float(jstats["grad_norm"]) + 1e-9))
        assert_tree_close(ts.err, js.err, scales=jax.tree.map(
            lambda g: np.asarray(g, np.float32) * clip, jg))
    if scale > 1:
        assert float(jstats["grad_norm"]) > cfg.grad_clip


def test_apply_from_a_carried_reference_state():
    params, grads = trees(3)
    jp, jg = as_jax(params), as_jax(grads)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(CFG))
    _, js, _ = JO.apply(jp, jg, JO.init(jp, jcfg), jcfg)
    ts = O.load_reference_state(jax.tree.map(np.asarray, js), device="cpu")
    assert isinstance(ts, O.OptState) and ts.step.dtype == torch.int32
    tp = load_tree(jax.tree.map(np.asarray, jp), device="cpu")
    tg = load_tree(jax.tree.map(np.asarray, jg), device="cpu")
    got, gs, _ = O.apply(tp, tg, ts, CFG)
    want, ws, _ = JO.apply(jp, jg, js, jcfg)
    assert_tree_close(got, want)
    assert_tree_close(gs.mu, ws.mu)
    assert int(gs.step) == 2


def test_schedule_and_global_norm_match_reference():
    jcfg = JO.AdamWConfig()
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 12_000):
        got = O.schedule(O.AdamWConfig(), torch.tensor(step, dtype=torch.int32))
        want = JO.schedule(jcfg, jnp.int32(step))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    params, _ = trees(4)
    jp = as_jax(params)
    tp = load_tree(jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_allclose(float(O.global_norm(tp)),
                               float(JO.global_norm(jp)), rtol=1e-6)


def test_compress_round_trip_matches_reference():
    rng = np.random.default_rng(9)
    g = rng.standard_normal(257).astype(np.float32)
    g[:4] = [127.0 / 2, -127.0 / 2, 0.5 * 127 / 63.5, 0.0]   # halves
    err = (1e-3 * rng.standard_normal(257)).astype(np.float32)
    deq, res = O._compress_decompress(torch.from_numpy(g),
                                      torch.from_numpy(err))
    jdeq, jres = JO._compress_decompress(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), **TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-6,
                               atol=1e-9)
    # error feedback: the running average converges to the true gradient
    g = torch.tensor([1e-4, 1.0, -0.5])
    e, total = torch.zeros(3), torch.zeros(3)
    for _ in range(64):
        d, e = O._compress_decompress(g, e)
        total += d
    torch.testing.assert_close(total / 64, g, atol=1e-3, rtol=0)


@pytest.mark.parametrize("compress", [False, True])
def test_init_tree(compress):
    params, _ = trees(0)
    tp = load_tree(jax.tree.map(np.asarray, as_jax(params)), device="cpu")
    cfg = dataclasses.replace(CFG, compress=compress)
    st = O.init(tp, cfg)
    want = JO.init(as_jax(params), JO.AdamWConfig(**dataclasses.asdict(cfg)))
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    for part in ("mu", "nu", "err"):
        mine, ref = flatten(getattr(st, part))[0], jax.tree.leaves(
            getattr(want, part))
        for a, w in zip(mine, ref):
            assert tuple(a.shape) == w.shape and a.dtype == torch.float32
            assert not a.any()
