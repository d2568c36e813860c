"""ZeRO optimizer state (``optimizer.state_specs``, ``place_state``,
``apply`` on a placed state) and DIEN's row-sharded tables
(``dien.place_params``) against the unplaced port and the reference on
the CPU:

* three AdamW steps with the state laid out over CPU meshes ((2, 2)
  ``("data", "model")`` and a (3,) ``("model",)`` axis that divides no
  leaf evenly), with and without ``compress``: parameters, moments,
  residuals and stats within PR 22's AdamW tolerance (float32 rtol 1e-6
  and an atol of 1e-6 times the leaf's largest magnitude, bfloat16
  within one ulp, the stats within 1e-6) of the unplaced port's and of
  the reference's ``apply``; the state stays laid out;
* a replicated leaf counts once in the global norm, however many
  entries hold it;
* DIEN's forward and retrieval at ``SMOKE`` on row-sharded tables equal
  the port's unsharded ones bit for bit, and the reference's within
  1e-5 (rtol and atol), with carried weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dien import SMOKE as JAX_DIEN
from repro.models import dien as jdien
from repro.train import optimizer as JO
from repro_torch import sharding as SH
from repro_torch.configs.dien import SMOKE as DIEN
from repro_torch.launch.mesh import Placed, make_mesh
from repro_torch.models import dien as D
from repro_torch.models.common import load_tree
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import flatten

CFG = O.AdamWConfig(warmup_steps=2, total_steps=10)
SPECS = {"w": ("embed", "mlp"), "b": ("mlp",),
         "layers": [{"k": (None, "mlp")}, {"k": ("embed", None)}],
         "half": ()}
MESHES = {"2x2": ((2, 2), ("data", "model")), "3": ((3,), ("model",))}


def trees(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def draw(shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)
    params = {"w": draw((6, 5)), "b": draw((5,)),
              "layers": [{"k": draw((3, 4))}, {"k": draw((5, 4))}],
              "half": draw((7, 3))}
    grads = jax.tree.map(lambda x: draw(x.shape, scale), params)
    return params, grads


def as_jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(x).astype(
            jnp.bfloat16 if "half" in jax.tree_util.keystr(p) else
            jnp.float32), tree)


def to_port(tree):
    return load_tree(jax.tree.map(np.asarray, tree), device="cpu")


def bf16_close(got, want):
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= np.abs(want) * 2.0 ** -7 + 1e-30).all()


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["small", "clipped"])
def test_placed_adamw_matches_unplaced_and_reference(mesh_name, compress,
                                                     scale):
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    cfg = dataclasses.replace(CFG, compress=compress)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(cfg))
    params, _ = trees(0)
    jp = as_jax(params)
    tp = placed_p = to_port(jp)
    js, ts = JO.init(jp, jcfg), O.init(tp, cfg)
    ps = O.place_state(O.init(tp, cfg), O.state_specs(SPECS, compress),
                       mesh)
    for step in range(3):
        _, grads = trees(step + 1, scale)
        jg = as_jax(grads)
        tg = to_port(jg)
        jp, js, jstats = JO.apply(jp, jg, js, jcfg)
        tp, ts, tstats = O.apply(tp, tg, ts, cfg)
        placed_p, ps, pstats = O.apply(placed_p, tg, ps, cfg)
        assert O.is_placed(ps) and int(ps.step) == step + 1
        assert isinstance(ps.mu["w"], Placed)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pstats[name]),
                                       float(tstats[name]), rtol=1e-6)
            np.testing.assert_allclose(float(pstats[name]),
                                       float(jstats[name]), rtol=1e-6)
        whole = O.gather_state(ps)
        for got, port, ref in ((placed_p, tp, jp), (whole.mu, ts.mu, js.mu),
                               (whole.nu, ts.nu, js.nu)):
            for a, b, c in zip(flatten(got)[0], flatten(port)[0],
                               jax.tree.leaves(ref)):
                if a.dtype == torch.bfloat16:
                    bf16_close(a, b.float().numpy())
                    bf16_close(a, np.asarray(c.astype(jnp.float32)))
                    continue
                for w in (b.numpy(), np.asarray(c)):
                    floor = float(np.abs(w).max())
                    np.testing.assert_allclose(a.numpy(), w, rtol=1e-6,
                                               atol=1e-6 * floor)
        if compress:
            clip = min(1.0, cfg.grad_clip / (float(jstats["grad_norm"])
                                             + 1e-9))
            for a, b, g in zip(flatten(whole.err)[0], flatten(ts.err)[0],
                               jax.tree.leaves(jg)):
                floor = float(np.abs(np.asarray(g, np.float32)).max()) * clip
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-6 * floor)
        else:
            assert all(not x.any() for x in flatten(whole.err)[0])


def test_a_replicated_leaf_counts_once_in_the_norm():
    """A leaf held whole by all four entries (two distinct blocks of
    another leaf beside it) adds its sum of squares once: the step's
    ``grad_norm`` equals ``global_norm`` of the whole gradients, not
    the norm with the replicated leaf counted per entry."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    params = {"rep": torch.ones(4, 3), "split": torch.zeros(2, 6)}
    grads = {"rep": torch.full((4, 3), 2.0), "split": torch.ones(2, 6)}
    specs = {"rep": (), "split": (None, "mlp")}
    state = O.place_state(O.init(params, CFG), O.state_specs(specs), mesh)
    assert len(state.mu["rep"].blocks) == 1
    assert len(state.mu["split"].blocks) == 2
    _, _, stats = O.apply(params, grads, state, CFG)
    want = float(O.global_norm(grads))
    assert want == pytest.approx(np.sqrt(12 * 4 + 12))
    assert float(stats["grad_norm"]) == pytest.approx(want, rel=1e-7)
    per_entry = np.sqrt(4 * 12 * 4 + 12)
    assert abs(float(stats["grad_norm"]) - per_entry) > 1.0


def test_state_specs_replicate_the_residual_without_compress():
    specs = O.state_specs(SPECS)
    assert specs.mu is SPECS and specs.nu is SPECS and specs.step == ()
    assert flatten(SH.map_specs(lambda s: [len(s)], specs.err))[0] == \
        [0] * 5
    assert O.state_specs(SPECS, compress=True).err is SPECS


def dien_inputs(seed):
    from repro.data.pipelines import dien_batch
    c = JAX_DIEN
    b = dien_batch(0, 6, c.seq_len, c.n_items, c.n_cates, c.n_profile_vocab,
                   c.profile_bags, c.bag_size, seed=seed)
    rng = np.random.default_rng(seed)
    cand = {"item": rng.integers(0, c.n_items, (40,)).astype(np.int32),
            "cate": rng.integers(0, c.n_cates, (40,)).astype(np.int32)}
    return b, cand


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((3,), ("model",)),
                                        ((1, 4), ("data", "model"))])
def test_dien_on_row_sharded_tables(shape, axes):
    jp = jdien.init_params(JAX_DIEN, jax.random.PRNGKey(3))
    params = D.load_reference_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    placed = D.place_params(params, mesh)
    for name in D.TABLES:
        assert isinstance(placed[name], Placed)
        assert tuple(placed[name].sharding.spec) == ("model", None)
    assert placed["attn"] is params["attn"]
    batch, cand = dien_inputs(5)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tc = {k: torch.from_numpy(v) for k, v in cand.items()}
    with torch.no_grad():
        want = D.forward(params, tb, DIEN)
        got = D.forward(placed, tb, DIEN)
        want_r = D.retrieval_scores(params, tb, tc, DIEN)
        got_r = D.retrieval_scores(placed, tb, tc, DIEN)
    assert torch.equal(got, want) and torch.equal(got_r, want_r)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jdien.forward(jp, jb, JAX_DIEN))
    ref_r = np.asarray(jdien.retrieval_scores(
        jp, jb, {k: jnp.asarray(v) for k, v in cand.items()}, JAX_DIEN))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), ref_r, rtol=1e-5, atol=1e-5)
    ids = torch.tensor([[0, DIEN.n_items - 1, -1, 3]])
    assert torch.equal(D.take_rows(placed["item_table"], ids),
                       params["item_table"][ids])
