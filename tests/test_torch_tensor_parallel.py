"""The tensor-parallel serve path of the LMs (``transformer.place_params``,
``prefill`` / ``decode_step`` on the placed tree; ``attention.prefill_tp``,
``gqa_decode_tp``, ``mla_decode_tp``; ``moe.ffn_tp``; the vocab-parallel
embedding and head; ``launch.mesh.place_tree`` / ``psum``) against the
reference on the CPU, in float32 with carried weights:

* the tiny GQA config, qwen2-7b ``SMOKE`` (QKV bias) and
  deepseek-v2-236b ``SMOKE`` (MLA, MoE of 8 experts, capacity drops), at
  ``tp`` equal to the mesh's ``model`` size, over CPU meshes
  ``("model",)`` of 1, 2 and 4 entries and ``("data", "model")`` = (2,
  2): the prefill's logits and 4 decode steps (fixed tokens) within 1e-4
  of the reference's ``prefill`` / ``decode_step`` and of the port's
  unsharded path, and the gathered cache within 1e-4 of the reference's,
  for a prompt the ``model`` size divides (the sequence-parallel
  residual), one it does not, and the blockwise prefill;
* at one entry the tensor-parallel path is the unsharded one on the
  same sequence-sharded cache bit for bit;
* ``route`` inside the tensor-parallel MoE equals ``route`` with the
  whole router on the same tokens bit for bit, and the MoE output
  ``moe_dispatch``'s within 1e-5;
* each placed leaf's shards equal the reference leaf sliced by the
  ``PartitionSpec`` the reference's ``resolve`` gives on an
  ``AbstractMesh`` of the same shape under ``TP_ONLY``;
* a ``model`` size that does not divide the heads, a ``tp`` other than
  it, weights split over ``data`` and an unplaced cache raise
  ``ValueError``;
* the residual stream is laid out as sequence shards inside the prefill
  where ``t % tp == 0`` (``shard_act`` under the active rules), whole
  otherwise;
* an LM cell's ``get_fn(mesh, TP_ONLY)`` on arguments placed by its
  ``arg_specs`` equals ``get_fn()``'s unsharded step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as JS
from repro.models import transformer as jtf
from repro_torch import sharding as SH
from repro_torch.configs import get
from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Placed, gather, make_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as tf
from tests.test_torch_sharded_decode import config_pair

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = ("tiny", "qwen2_7b", "deepseek_v2_236b")
MESHES = {"model1": ((1,), ("model",)), "model2": ((2,), ("model",)),
          "model4": ((4,), ("model",)),
          "data2_model2": ((2, 2), ("data", "model"))}
#: (prompt length, s_max, blockwise_prefill_from, prefill_block_k): a
#: prompt every model size divides (the sequence-parallel residual), one
#: 2 and 4 do not, and the blockwise prefill in blocks of 4.
CASES = {"seq_parallel": (8, 16, 8192, 1024), "ragged": (9, 16, 8192, 1024),
         "blockwise": (8, 16, 8, 4)}
STEPS = 4


def configs(name, p, case):
    """(reference config, port config) at ``tp = p`` for ``case``."""
    jcfg, tcfg = config_pair(name)
    _, _, start, block = CASES[case]
    kw = dict(tp=p, blockwise_prefill_from=start, prefill_block_k=block)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def tp_mesh(key):
    shape, axes = MESHES[key]
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


@functools.lru_cache(maxsize=None)
def reference_run(name, p, case):
    """The reference's prefill and decode steps (jitted): (its params as
    numpy, prompt, fed tokens, logits of the prefill and every step,
    cache)."""
    jcfg, _ = configs(name, p, case)
    t, s_max, _, _ = CASES[case]
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(11))
    rng = np.random.default_rng(t * 7 + p)
    toks = rng.integers(0, jcfg.vocab, (2, t)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab, (2, STEPS)).astype(np.int32)
    prefill = jax.jit(jtf.prefill, static_argnums=(2, 3))
    decode = jax.jit(jtf.decode_step, static_argnums=(3,))
    lg, jc = prefill(jp, jnp.asarray(toks), jcfg, s_max)
    logits = [np.asarray(lg)]
    for i in range(STEPS):
        lg, jc = decode(jp, jc, jnp.asarray(fed[:, i]), jcfg)
        logits.append(np.asarray(lg))
    return (jax.tree.map(np.asarray, jp), toks, fed, np.stack(logits),
            jax.tree.map(np.asarray, jc))


def serve(params, cfg, toks, fed, s_max, mesh=None):
    """Prefill (its cache laid out over ``mesh`` when given) and STEPS
    decode steps on fixed tokens: (logits of each [STEPS + 1, b, V], the
    last cache)."""
    lg, cache = tf.prefill(params, torch.from_numpy(toks), cfg, s_max,
                           mesh=mesh)
    out = [lg]
    for i in range(STEPS):
        lg, cache = tf.decode_step(params, cache, torch.from_numpy(fed[:, i]),
                                   cfg)
        out.append(lg)
    return torch.stack(out), cache


#: Every mesh on the sequence-parallel prompt; the ragged one where the
#: model size does not divide it, the blockwise prefill at 2 entries.
SERVE = [(m, "seq_parallel") for m in MESHES] + [
    ("model4", "ragged"), ("data2_model2", "ragged"),
    ("model2", "blockwise"), ("data2_model2", "blockwise")]


@pytest.mark.parametrize("mesh_key,case", SERVE)
@pytest.mark.parametrize("name", CONFIGS)
def test_tp_serve_matches_reference_and_unsharded(name, mesh_key, case):
    mesh = tp_mesh(mesh_key)
    p = mesh.shape["model"]
    jp, toks, fed, want, jc = reference_run(name, p, case)
    _, tcfg = configs(name, p, case)
    s_max = CASES[case][1]
    params = tf.load_reference_params(jp, device="cpu")
    placed = tf.place_params(params, tcfg, mesh)
    got, cache = serve(placed, tcfg, toks, fed, s_max)
    plain, plain_cache = serve(params, tcfg, toks, fed, s_max)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, plain, **TOL)
    if p == 1:
        # the unsharded weights on the same sequence-sharded cache
        assert torch.equal(got, serve(params, tcfg, toks, fed, s_max,
                                      mesh)[0])
    assert cache["lengths"].tolist() == [CASES[case][0] + STEPS] * 2
    for n in tf.cache_names(tcfg):
        assert isinstance(cache[n], Placed)
        np.testing.assert_allclose(gather(cache[n]).numpy(), jc[n], **TOL)
        torch.testing.assert_close(gather(cache[n]), plain_cache[n], **TOL)


@pytest.mark.parametrize("mesh_key", ["model2", "data2_model2"])
def test_tp_route_is_the_whole_routers_bit_for_bit(monkeypatch, mesh_key):
    """Every ``route`` of the tensor-parallel prefill and decode (the
    router replicated) equals ``route`` with the layer's whole router on
    the same tokens in every field; the tensor-parallel MoE output equals
    ``moe_dispatch``'s on the same input within 1e-5."""
    mesh = tp_mesh(mesh_key)
    jp, toks, fed, _, _ = reference_run("deepseek_v2_236b", 2, "ragged")
    _, tcfg = configs("deepseek_v2_236b", 2, "ragged")
    params = tf.load_reference_params(jp, device="cpu")
    seen, outs = [], []
    route, dispatch_tp = M.route, M.moe_dispatch_tp

    def recorded_route(router, tokens, cfg):
        r = route(router, tokens, cfg)
        seen.append((router, tokens, r))
        return r

    def recorded_dispatch(groups, x, cfg):
        out = dispatch_tp(groups, x, cfg)
        outs.append((x, out))
        return out
    monkeypatch.setattr(M, "route", recorded_route)
    monkeypatch.setattr(M, "moe_dispatch_tp", recorded_dispatch)
    serve(tf.place_params(params, tcfg, mesh), tcfg, toks, fed, 16)
    monkeypatch.setattr(M, "route", route)
    assert len(seen) == len(outs) == tcfg.n_layers * (STEPS + 1)
    routers = params["layers"]["ffn"]["router"]
    for i, (router, tokens, r) in enumerate(seen):
        whole = routers[i % tcfg.n_layers]
        assert torch.equal(router, whole)
        want = route(whole, tokens, tcfg)
        for field, a, b in zip(r._fields, r, want):
            assert (a == b if field == "cap" else torch.equal(a, b)), field
    for i, (x, out) in enumerate(outs):
        lp = {k: v[i % tcfg.n_layers]
              for k, v in params["layers"]["ffn"].items()}
        torch.testing.assert_close(out, M.moe_dispatch(lp, x, tcfg)[0],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh_key", ["model2", "model4", "data2_model2"])
@pytest.mark.parametrize("name", CONFIGS)
def test_placed_shards_are_the_reference_leaves_sliced(name, mesh_key):
    mesh = tp_mesh(mesh_key)
    p = mesh.shape["model"]
    jp = reference_run(name, p, "seq_parallel")[0]
    jcfg, tcfg = configs(name, p, "seq_parallel")
    placed = tf.place_params(tf.load_reference_params(jp, device="cpu"),
                             tcfg, mesh)
    shape, axes = MESHES[mesh_key]
    jshard = JS.resolve_tree(jtf.param_specs(jcfg), JS.TP_ONLY,
                             AbstractMesh(shape, axes))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(placed))
    for path, want in flat:
        keys = [k.key for k in path]
        got, spec = placed, jshard
        for k in keys:
            got, spec = got[k], spec[k]
        assert tuple(got.sharding.spec) == tuple(spec.spec), keys
        for e, (coords, _) in enumerate(got.sharding.entries()):
            sl = []
            for i, n in enumerate(want.shape):
                entry = spec.spec[i] if i < len(spec.spec) else None
                ax = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                parts = int(np.prod([mesh.shape[a] for a in ax]))
                idx = 0
                for a in ax:
                    idx = idx * mesh.shape[a] + coords[a]
                sl.append(slice(idx * n // parts, (idx + 1) * n // parts))
            np.testing.assert_array_equal(got.shard(e).numpy(),
                                          want[tuple(sl)], err_msg=str(keys))


def test_tp_raises_where_it_cannot_run():
    _, tcfg = configs("qwen2_7b", 2, "seq_parallel")
    params = tf.init_params(tcfg, device="cpu")
    three = make_mesh((3,), ("model",), ["cpu"] * 3)
    with pytest.raises(ValueError, match="heads"):
        tf.place_params(params, tcfg, three)
    with pytest.raises(ValueError, match="tp = 2"):
        tf.place_params(params, tcfg, tp_mesh("model4"))
    with pytest.raises(ValueError, match="model"):
        tf.place_params(params, tcfg, make_mesh((2,), ("data",),
                                                ["cpu"] * 2))
    mesh = tp_mesh("data2_model2")
    fsdp = tf.place_params(params, tcfg, mesh, rules=SH.FSDP_TP)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    placed = tf.place_params(params, tcfg, mesh)
    # weights split over "data" too serve (each entry gathers its view of
    # a layer): the same bits as the TP_ONLY tree
    assert torch.equal(tf.prefill(fsdp, toks, tcfg, 16)[0],
                       tf.prefill(placed, toks, tcfg, 16)[0])
    with pytest.raises(ValueError, match="cache"):
        tf.decode_step(placed, tf.init_cache(tcfg, 2, 16, device="cpu"),
                       toks[:, 0], tcfg)


@pytest.mark.parametrize("t,sharded", [(8, True), (9, False)])
def test_prefill_lays_the_residual_out_by_act_spec(monkeypatch, t, sharded):
    _, tcfg = configs("tiny", 2, "seq_parallel")
    mesh = tp_mesh("model2")
    placed = tf.place_params(tf.init_params(tcfg, device="cpu"), tcfg, mesh)
    seen = []
    residual = tf._residual

    def recorded(x, spec, mesh, rules):
        out = residual(x, spec, mesh, rules)
        seen.append((spec, out))
        return out
    monkeypatch.setattr(tf, "_residual", recorded)
    x = torch.randn(2, t, tcfg.d_model)
    assert SH.shard_act(x, tf.act_spec(tcfg, t)) is x
    tf.prefill(placed, torch.zeros((2, t), dtype=torch.int32), tcfg, 16)
    (spec, out), = seen
    assert spec == tf.act_spec(tcfg, t)
    if sharded:
        assert isinstance(out, Placed)
        assert tuple(out.sharding.spec) == (None, "model", None)
        assert [b[1] for _, b, _ in out.blocks] == \
            [(0, t // 2), (t // 2, t)]
    else:
        assert torch.is_tensor(out)
    assert not SH._ACT_CTX


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b"])
def test_lm_cells_get_fn_runs_the_tp_path(arch):
    """``get_fn(mesh, TP_ONLY)`` of a prefill and a decode cell (the
    SMOKE config at tp 2, float32, its shapes cut) on arguments placed by
    ``place_args``: the unsharded ``get_fn()``'s logits within 1e-4."""
    spec = get(arch)
    cfg = dataclasses.replace(spec.smoke, tp=2, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    spec = dataclasses.replace(spec, config=cfg)
    mesh = tp_mesh("data2_model2")
    dims = dict(global_batch=2, seq_len=12)
    pre = S.lm_bundle(spec, ShapeSpec("prefill_32k", "prefill", dims), False)
    dec = S.lm_bundle(spec, ShapeSpec("decode_32k", "decode", dims), False)
    params = tf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    args = pre.place_args((params, toks), mesh, SH.TP_ONLY)
    assert all(isinstance(x, Placed) for x in jax.tree.leaves(
        args[0], is_leaf=lambda x: isinstance(x, Placed)))
    got, cache = pre.get_fn(mesh, SH.TP_ONLY)(*args)
    want, plain = pre.get_fn()(params, toks)
    torch.testing.assert_close(got, want, **TOL)
    token = want.argmax(-1).to(torch.int32)
    _, cache, token_p = dec.place_args((params, cache, token), mesh,
                                       SH.TP_ONLY)
    for _ in range(3):
        got, cache = dec.get_fn(mesh, SH.TP_ONLY)(args[0], cache, token_p)
        want, plain = dec.get_fn()(params, plain, token)
        torch.testing.assert_close(got, want, **TOL)
        token = want.argmax(-1).to(torch.int32)
        token_p = token
