"""The port's mixture of experts (``repro_torch.models.moe``) against
the reference's ``moe_ffn`` on the CPU, with the reference's
``init_moe`` weights carried across and the same numpy inputs:

* the routing first, exactly: the top-k experts equal the reference's
  ``lax.top_k`` (recorded from its own call), and ``keep`` and the
  slots equal the reference's rule applied to them (a stable sort by
  expert, the rank within an expert, the capacity per group);
* then the output and the aux loss, within 1e-5 in float32, and in
  bfloat16 within 3e-2 (a few bf16 ulps, 2^-8 relative each: the
  expert products are summed in another order before each rounding);
* at group counts that divide the tokens and ones that must halve, at a
  capacity factor that drops (0.5), the default (1.25) and the no-drop
  factor e / k, with ``moe_norm_topk`` on and off;
* ties in the router go to the lower expert id, as ``lax.top_k``'s do;
* ``moe_dispatch`` is ``moe_ffn`` without the aux loss, which serving
  never computes;
* ``chip_smoke.py``'s drop count, the no-drop factor and the float32
  router of ``init_moe`` whatever ``param_dtype`` is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import transformer as jtf
from repro_torch.models import moe as M
from repro_torch.models import transformer as tf

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def cfg_pair(dtype="f32", **kw):
    base = dict(name="m", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab=64, d_head=16, tp=1, moe_experts=8,
                moe_shared=2, moe_top_k=2, moe_d_ff=16)
    base.update(kw)
    td, jd = DTYPES[dtype]
    return (jtf.TransformerConfig(param_dtype=jd, act_dtype=jd, **base),
            tf.TransformerConfig(param_dtype=td, act_dtype=td, **base))


def weights(jcfg, seed):
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, tf.load_reference_params(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def inputs(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    td, jd = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def reference_call(jp, jx, jcfg, monkeypatch):
    """The reference's ``moe_ffn`` output and aux, and the (top_p, top_e)
    its ``lax.top_k`` returned."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "top_k", recording)
    out, aux = JM.moe_ffn(jp, jx, jcfg)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return out, aux, tuple(np.asarray(a) for a in seen[0])


def reference_slots(top_e, e, cap):
    """The reference's dispatch rule on its own top-k experts [g, tg, k]:
    a stable sort by expert per group, the rank within an expert, keep
    below the capacity, dropped ones on the dump expert e, row 0."""
    g, tg, k = top_e.shape
    flat = top_e.reshape(g, tg * k)
    order = np.argsort(flat, axis=1, kind="stable")
    se = np.take_along_axis(flat, order, axis=1)
    pos = np.arange(tg * k)[None] - np.stack(
        [np.searchsorted(row, row, side="left") for row in se])
    keep = pos < cap
    return (order // k, keep, np.where(keep, se, e), np.where(keep, pos, 0))


CASES = [
    # (b, t, moe_groups, capacity factor): groups that divide, groups that
    # halve (24 % 16 -> 8; 24 % 5 -> 2), fewer tokens than groups, and
    # factors that drop (0.5), the default and never drop (e / k = 4)
    (2, 12, 4, 0.5), (2, 12, 16, 1.25), (2, 12, 5, 4.0), (1, 3, 16, 1.25),
    (3, 10, 16, 0.5), (4, 16, 1, 1.0),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("b,t,groups,factor", CASES)
def test_moe_ffn_routes_and_computes_as_the_reference(b, t, groups, factor,
                                                      norm, dtype,
                                                      monkeypatch):
    jcfg, tcfg = cfg_pair(dtype, moe_groups=groups,
                          moe_capacity_factor=factor, moe_norm_topk=norm)
    jp, tp = weights(jcfg, b * 100 + t)
    jx, tx = inputs((b, t, 32), dtype, groups)
    want, want_aux, (ref_p, ref_e) = reference_call(jp, jx, jcfg,
                                                    monkeypatch)
    g, tg, cap = M.dispatch_shape(b * t, tcfg)
    assert ref_e.shape == (g, tg, 2)
    r = M.route(tp["router"], tx.reshape(g, tg, 32), tcfg)
    # the routing, exactly, before any number
    np.testing.assert_array_equal(r.top_e.numpy(), ref_e)
    st, keep, slot_e, slot_c = reference_slots(ref_e, 8, cap)
    for got, exp in ((r.st, st), (r.keep, keep), (r.slot_e, slot_e),
                     (r.slot_c, slot_c)):
        np.testing.assert_array_equal(got.numpy(), exp)
    assert r.cap == cap
    p_ref = ref_p / ref_p.sum(-1, keepdims=True) if norm else ref_p
    np.testing.assert_allclose(r.top_p.numpy(), p_ref, rtol=1e-6, atol=1e-7)
    if factor >= M.no_drop_capacity_factor(tcfg):
        assert keep.all()
    if factor == 0.5:
        assert not keep.all()
    out, aux = M.moe_ffn(tp, tx, tcfg)
    assert out.dtype == tx.dtype and out.shape == (b, t, 32)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)


def test_router_ties_go_to_the_lower_expert(monkeypatch):
    """A zero token gives every expert the same probability: the
    reference's top_k takes experts 0 and 1, and so does the port."""
    jcfg, tcfg = cfg_pair(moe_groups=2)
    jp, tp = weights(jcfg, 1)
    x = np.random.default_rng(2).standard_normal((1, 4, 32)).astype(
        np.float32)
    x[0, 1] = 0.0
    want, _, (_, ref_e) = reference_call(jp, jnp.asarray(x), jcfg,
                                         monkeypatch)
    r = M.route(tp["router"], torch.from_numpy(x).reshape(2, 2, 32), tcfg)
    assert ref_e[0, 1].tolist() == [0, 1]
    np.testing.assert_array_equal(r.top_e.numpy(), ref_e)
    out, _ = M.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)


def test_group_count_and_capacity_follow_the_reference_rule():
    _, cfg = cfg_pair(moe_groups=16, moe_capacity_factor=1.25)
    assert M.dispatch_shape(24, cfg) == (8, 3, 1)        # 16 -> 8
    assert M.dispatch_shape(3, cfg) == (3, 1, 1)         # min(16, 3)
    assert M.dispatch_shape(65536, cfg) == (16, 4096, 1280)
    _, lite = cfg_pair(moe_groups=16, moe_experts=64, moe_top_k=6)
    assert M.dispatch_shape(2 * 32768, lite)[2] == 480   # ceil(4096*6/64*1.25)
    assert M.no_drop_capacity_factor(lite) == 64 / 6
    no_drop = dataclasses.replace(lite, moe_capacity_factor=64 / 6)
    _, tg, cap = M.dispatch_shape(1000, no_drop)
    assert cap >= tg


def test_drop_counter_counts_what_the_capacity_drops():
    """``chip_smoke.py``'s drop count, which wraps ``route`` only while
    it watches: the model keeps no counter of its own."""
    import chip_smoke
    _, cfg = cfg_pair(moe_groups=2, moe_capacity_factor=0.5)
    _, tp = weights(cfg_pair()[0], 4)
    _, tx = inputs((2, 12, 32), "f32", 4)
    g, tg, _ = M.dispatch_shape(24, cfg)
    keep = M.route(tp["router"], tx.reshape(g, tg, 32), cfg).keep
    drops = chip_smoke.DropCount()
    assert drops.share() == 0.0
    with drops.watch():
        M.moe_ffn(tp, tx, cfg)
        M.moe_dispatch(tp, tx, cfg)
    M.moe_ffn(tp, tx, cfg)                       # not watched
    assert drops.assigned == 2 * 24 * 2
    assert int(drops.dropped) == 2 * int((~keep).sum()) > 0
    assert drops.share() == pytest.approx(float((~keep).float().mean()))
    assert not hasattr(M, "drops")
    drops = chip_smoke.DropCount()
    with drops.watch():
        M.moe_ffn(tp, tx, dataclasses.replace(
            cfg, moe_capacity_factor=M.no_drop_capacity_factor(cfg)))
    assert drops.share() == 0.0 and drops.assigned == 48


def test_dispatch_is_moe_ffn_without_the_aux_loss(monkeypatch):
    """``moe_dispatch`` gives ``moe_ffn``'s output and the routing, and
    serving (``prefill``, ``decode_step``) never computes the aux loss."""
    _, cfg = cfg_pair(moe_groups=2)
    _, tp = weights(cfg_pair()[0], 5)
    _, tx = inputs((2, 6, 32), "f32", 5)
    out, aux = M.moe_ffn(tp, tx, cfg)
    got, r = M.moe_dispatch(tp, tx, cfg)
    assert torch.equal(got, out)
    assert float(M.aux_loss(r, cfg.moe_experts)) == float(aux)

    def no_aux(*args):
        raise AssertionError("serving computed the aux loss")
    monkeypatch.setattr(M, "aux_loss", no_aux)
    scfg = dataclasses.replace(cfg, n_layers=2)
    params = tf.init_params(scfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, scfg.vocab, (2, 5)).astype(np.int32))
    logits, cache = tf.prefill(params, prompts, scfg, 8)
    logits, cache = tf.decode_step(
        params, cache, logits.argmax(-1).to(torch.int32), scfg)
    assert torch.isfinite(logits).all()
    with pytest.raises(AssertionError, match="aux loss"):
        M.moe_ffn(tp, tx, cfg)


def test_init_moe_tree_matches_the_reference():
    jcfg, tcfg = cfg_pair("bf16")
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = M.init_moe(tcfg, generator=gen, device="cpu", lead=(3,))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + v.shape, k
        assert (tp[k].dtype == torch.float32) == (v.dtype == jnp.float32), k
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    # each layer's experts drawn N(0, 1 / d): every layer differs
    assert not torch.equal(tp["w_gate"][0], tp["w_gate"][1])
    std = float(tp["w_gate"].float().std())
    assert abs(std - 32 ** -0.5) < 0.01


def test_undispatch_adds_each_tokens_rows_in_sorted_order():
    """``moe.undispatch`` sums each token's k rows one add at a time in
    sorted-assignment order (ascending expert), in the rows' dtype: bit
    for bit a sequential loop over the sorted assignments, and in
    float32 the scatter-add it replaced up to rounding."""
    g, tg, k, d = 2, 5, 3, 8
    gen = torch.Generator().manual_seed(3)
    flat_e = torch.stack([torch.randperm(6, generator=gen)[:k]
                          for _ in range(g * tg)]).reshape(g, tg * k)
    st = torch.sort(flat_e, dim=1, stable=True).indices // k   # as route's
    for dtype in (torch.bfloat16, torch.float32):
        rows = torch.randn((g, tg * k, d), generator=gen).to(dtype)
        got = M.undispatch(rows, st, k)
        want = torch.zeros((g, tg, d), dtype=dtype)
        seen = torch.zeros((g, tg), dtype=torch.bool)
        for gi in range(g):
            for i in range(tg * k):               # sorted order
                t = int(st[gi, i])
                want[gi, t] = rows[gi, i] if not seen[gi, t] else \
                    want[gi, t] + rows[gi, i]
                seen[gi, t] = True
        assert torch.equal(got, want), dtype
    scattered = torch.zeros((g, tg, d)).scatter_add_(
        1, st[..., None].expand(-1, -1, d), rows)
    torch.testing.assert_close(got, scattered, rtol=1e-6, atol=1e-6)
