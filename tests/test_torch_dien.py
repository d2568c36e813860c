"""The port's DIEN (``repro_torch.models.dien``, ``configs/dien.py``,
``data/pipelines.py::dien_batch``) against the reference
(``repro.models.dien``) on the CPU, in float32, at ``SMOKE`` (500 items,
20 categories, T 10) with the reference's ``init_params`` carried across
by ``load_reference_params`` and the same ``dien_batch``:

* ``dien_batch`` bitwise; the configuration, the registry entry and
  ``RECSYS_SHAPES`` equal to the reference's;
* ``forward`` and ``retrieval_scores`` within rtol 1e-5 / atol 1e-6
  (also on a row whose history is all masked: ``lengths - 1`` clamps
  at 0), the GRU cell with and without the AUGRU's attention;
* ``make_train_loss`` and every gradient within rtol 1e-4 / atol 1e-6;
* the parameter tree's layout and dtypes equal to the reference's;
* the GRU is the reference's (reset gate before the product), which
  ``torch.nn.GRUCell``'s formula is not."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dien as JC
from repro.configs import get as jax_get
from repro.configs.common import RECSYS_SHAPES as J_SHAPES
from repro.data.pipelines import dien_batch as j_dien_batch
from repro.models import dien as JD
from repro_torch import configs
from repro_torch.configs import dien as TC
from repro_torch.configs.common import RECSYS_SHAPES
from repro_torch.data.pipelines import dien_batch
from repro_torch.models import dien as D
from repro_torch.train.checkpoint import flatten
from repro_torch.train.loop import value_and_grad

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def setup(seed=0, b=16, cfg=TC.SMOKE, rcfg=JC.SMOKE):
    """(reference params, port params, numpy batch)."""
    jp = JD.init_params(rcfg, jax.random.PRNGKey(seed))
    tp = D.load_reference_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch = dien_batch(seed, b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                       cfg.n_profile_vocab, seed=seed + 1)
    return jp, tp, batch


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def th(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("step,b,seed", [(0, 16, 0), (3, 5, 7)])
def test_dien_batch_matches_reference(step, b, seed):
    c = TC.SMOKE
    args = (step, b, c.seq_len, c.n_items, c.n_cates, c.n_profile_vocab)
    got, want = dien_batch(*args, seed=seed), j_dien_batch(*args, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_config_registry_and_shapes_match_reference():
    for mine, ref in ((TC.CONFIG, JC.CONFIG), (TC.SMOKE, JC.SMOKE)):
        d = dataclasses.asdict(mine)
        assert d.pop("dtype") == torch.float32
        r = dataclasses.asdict(ref)
        assert r.pop("dtype") == jnp.float32
        assert d == r and mine.beh_dim == ref.beh_dim
    spec, ref = configs.get("dien"), jax_get("dien")
    assert (spec.arch_id, spec.family, spec.source) == \
        (ref.arch_id, ref.family, ref.source)
    assert spec is TC.SPEC and (spec.config, spec.smoke) == (TC.CONFIG,
                                                             TC.SMOKE)
    assert {k: dataclasses.asdict(s) for k, s in RECSYS_SHAPES.items()} == \
        {k: dataclasses.asdict(s) for k, s in J_SHAPES.items()}
    assert spec.shapes is RECSYS_SHAPES


def test_init_params_tree_matches_reference():
    tp = D.init_params(TC.SMOKE, device="cpu")
    jp = JD.init_params(JC.SMOKE, jax.random.PRNGKey(0))
    mine, td = flatten(tp)
    ref = jax.tree.leaves(jp)
    assert str(td) == str(jax.tree.structure(jp))
    for a, b in zip(mine, ref):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    assert float(tp["head"][0]["p"][0]) == 0.25
    assert float(tp["item_table"].std()) == pytest.approx(0.01, rel=0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    jp, tp, batch = setup(seed)
    want = np.asarray(JD.forward(jp, jx(batch), JC.SMOKE))
    got = D.forward(tp, th(batch), TC.SMOKE)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_retrieval_scores_match_reference():
    jp, tp, batch = setup(2, b=3)
    batch["hist_mask"][1] = False                 # lengths - 1 = -1 -> 0
    rng = np.random.default_rng(5)
    cand = {"item": rng.integers(0, 500, 40).astype(np.int32),
            "cate": rng.integers(0, 20, 40).astype(np.int32)}
    want = np.asarray(JD.retrieval_scores(jp, jx(batch), jx(cand),
                                          JC.SMOKE))
    got = D.retrieval_scores(tp, th(batch), th(cand), TC.SMOKE)
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("augru", [False, True])
def test_gru_cell_is_the_reference_cell(augru):
    jp, tp, _ = setup(3)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((6, 108)).astype(np.float32)
    x = rng.standard_normal((6, 36)).astype(np.float32)
    a = rng.uniform(size=(6, 1)).astype(np.float32) if augru else None
    want = np.asarray(JD._gru_cell(jp["augru"], jnp.asarray(h),
                                   jnp.asarray(x),
                                   None if a is None else jnp.asarray(a)))
    p = tp["augru"]
    got = D._gru_cell(p, torch.from_numpy(h), torch.from_numpy(x),
                      None if a is None else torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    # PyTorch's GRU applies r after the product: another function
    dh = 108
    ht, xt = torch.from_numpy(h), torch.from_numpy(x)
    xw, hw = xt @ p["wx"], ht @ p["wh"]
    u = torch.sigmoid(xw[:, :dh] + hw[:, :dh] + p["b"][:dh])
    r = torch.sigmoid(xw[:, dh:2 * dh] + hw[:, dh:2 * dh] + p["b"][dh:2 * dh])
    c = torch.tanh(xw[:, 2 * dh:] + r * hw[:, 2 * dh:] + p["b"][2 * dh:])
    if a is not None:
        u = torch.from_numpy(a) * u
    torch_gru = (1 - u) * ht + u * c
    assert not np.allclose(torch_gru.numpy(), want, **FWD)


@pytest.mark.parametrize("seed", [0, 3])
def test_train_loss_and_gradients_match_reference(seed):
    jp, tp, batch = setup(seed)
    lw, gw = jax.value_and_grad(JD.make_train_loss(JC.SMOKE))(jp, jx(batch))
    lt, gt = value_and_grad(D.make_train_loss(TC.SMOKE), tp, th(batch))
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lw), **GRAD)
    mine, td = flatten(gt)
    assert str(td) == str(jax.tree.structure(gw))
    for a, w in zip(mine, jax.tree.leaves(gw)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD)
    # the aux term is in the loss: without it the loss moves
    no_aux = dataclasses.replace(TC.SMOKE, aux_weight=0.0)
    assert abs(float(D.make_train_loss(no_aux)(tp, th(batch))) - float(lw)) \
        > 1e-3


def test_profile_embed_means_every_id_and_device_defaults_to_the_card():
    _, tp, batch = setup(0, b=2)
    got = D.profile_embed(tp, torch.from_numpy(batch["profile"]), TC.SMOKE)
    want = tp["profile_table"][torch.from_numpy(batch["profile"][0, 1])]
    torch.testing.assert_close(got[0, 18:36], want.mean(dim=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            D.init_params(TC.SMOKE)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            D.load_reference_params({"a": np.zeros(2)})
