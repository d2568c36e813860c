"""The port's train losses against the reference's on the CPU, with the
reference's parameters carried across and the same seeded numpy inputs:

* ``lm_batch`` bitwise, and ``softmax_cross_entropy`` (float32 and
  bfloat16 logits) within 1e-6;
* ``transformer.make_train_loss`` of every LM ``SMOKE`` configuration
  (qwen2-1.5b, qwen2-7b, phi3-medium-14b; deepseek-v2-lite-16b and
  deepseek-v2-236b with MLA and the MoE's switch aux loss), the loss and
  every gradient: in float32 within rtol 1e-4 / atol 1e-5, in bfloat16
  (the configurations' own dtype) within a relative L2 of 3e-2 a leaf;
  the reference's float32 loss is float64 (under x64 its dense layers'
  aux ``0.0`` is stacked as float64, and the MoE's density is a
  ``jax.nn.one_hot`` in the default float64), the port's float32;
* ``remat`` on and off give bitwise-equal losses and gradients;
* the GNN ``make_loss``es (EGNN, NequIP, Equiformer-v2 on a molecule
  pair, PNA's node cross-entropy), loss and every gradient within rtol
  1e-4 / atol 1e-5.

In bfloat16 the MoE configurations run with a zero router in both
packages: every token then routes to experts 0 and 1 (ties go to the
lower id in both) and the capacity drops the same assignments.  At the
drawn router a one-ulp difference of a router input flips top-k choices
between the packages: the reference's own bfloat16 gradients then sit a
relative L2 of up to 0.36 from its float32 ones on the same weights
(deepseek-v2-lite SMOKE, seed 0), so no bfloat16 tolerance can hold
them."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipelines import lm_batch as j_lm_batch
from repro.models import common as JCM
from repro.models import transformer as jtf
from repro.models.gnn import egnn as JE
from repro.models.gnn import equiformer_v2 as JQ
from repro.models.gnn import nequip as JN
from repro.models.gnn import pna as JP
from repro_torch.data.pipelines import lm_batch
from repro_torch.models import transformer as tf
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.gnn import egnn as TE
from repro_torch.models.gnn import equiformer_v2 as TQ
from repro_torch.models.gnn import nequip as TN
from repro_torch.models.gnn import pna as TP
from repro_torch.train.checkpoint import flatten
from repro_torch.train.loop import value_and_grad
from tests.test_torch_egnn import graph_pair

LM_MODULES = ("qwen2_1_5b", "qwen2_7b", "phi3_medium_14b",
              "deepseek_v2_lite_16b", "deepseek_v2_236b")
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL_L2 = 3e-2
_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def to_jax(cfg):
    d = dataclasses.asdict(cfg)
    d["param_dtype"] = _DTYPES[cfg.param_dtype]
    d["act_dtype"] = _DTYPES[cfg.act_dtype]
    return jtf.TransformerConfig(**d)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("step,shape,vocab,seed", [
    (0, (2, 16), 512, 1), (5, (3, 33), 151936, 0), (1, (1, 8), 7, 2)])
def test_lm_batch_matches_reference(step, shape, vocab, seed):
    got = lm_batch(step, *shape, vocab, seed=seed)
    want = j_lm_batch(step, *shape, vocab, seed=seed)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = JCM.softmax_cross_entropy(jnp.asarray(logits).astype(jd),
                                     jnp.asarray(labels))
    got = softmax_cross_entropy(torch.from_numpy(logits).to(td),
                                torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def lm_case(module, dtype):
    cfg = importlib.import_module(f"repro_torch.configs.{module}").SMOKE
    cfg = dataclasses.replace(cfg, param_dtype=dtype, act_dtype=dtype)
    jcfg = to_jax(cfg)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if cfg.is_moe and dtype == torch.bfloat16:     # module doc
        jp["layers"]["ffn"]["router"] = jp["layers"]["ffn"]["router"] * 0
    tp = tf.load_reference_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch = lm_batch(0, 2, 16, cfg.vocab, seed=1)
    return cfg, jcfg, jp, tp, batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_train_loss_and_gradients_match_reference(module, dtype):
    cfg, jcfg, jp, tp, batch = lm_case(module, dtype)
    lw, gw = jax.value_and_grad(jtf.make_train_loss(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, gt = value_and_grad(tf.make_train_loss(cfg), tp,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    assert lt.dtype == torch.float32
    mine, td = flatten(gt)
    assert str(td) == str(jax.tree.structure(gw))
    ref = [np.asarray(w.astype(jnp.float32)) for w in jax.tree.leaves(gw)]
    if dtype == torch.float32:
        assert lw.dtype == jnp.float64          # the reference's x64 leak
        np.testing.assert_allclose(float(lt), float(lw), **F32)
        for a, w in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), w, **F32)
    else:
        assert abs(float(lt) - float(lw)) <= BF16_REL_L2 * abs(float(lw))
        for a, w, p in zip(mine, ref, flatten(tp)[0]):
            assert a.dtype == p.dtype         # the router stays float32
            assert rel_l2(a.float().numpy(), w) <= BF16_REL_L2


@pytest.mark.parametrize("module", ["qwen2_1_5b", "deepseek_v2_lite_16b"])
def test_remat_gives_bitwise_equal_gradients(module):
    cfg, _, _, tp, batch = lm_case(module, torch.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(value_and_grad(tf.make_train_loss(c), tp, tb))
    (l1, g1), (l2, g2) = out
    assert cfg.remat and l1.item() == l2.item()
    for a, b in zip(flatten(g1)[0], flatten(g2)[0]):
        assert torch.equal(a, b)


def gnn_grads_close(model, loss_fn, params_tree, jloss, jgrads, inputs):
    """The port's loss and gradients of ``model`` against the
    reference's ``jloss`` / ``jgrads``: the reference's gradient tree is
    loaded into a copy of the module (its own layout map), which is then
    held name by name against the port's gradients."""
    params = dict(model.named_parameters())
    lt, gt = value_and_grad(loss_fn, params, inputs)
    np.testing.assert_allclose(float(lt), float(jloss), **F32)
    as_module = type(model)(model.cfg, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, jgrads))
    want = dict(as_module.named_parameters())
    assert gt.keys() == want.keys()
    for name, g in gt.items():
        np.testing.assert_allclose(g.numpy(), want[name].detach().numpy(),
                                   err_msg=name, **F32)


@pytest.mark.parametrize("arch", ["egnn", "nequip", "equiformer_v2"])
def test_molecule_losses_match_reference(arch):
    jmod = {"egnn": JE, "nequip": JN, "equiformer_v2": JQ}[arch]
    tmod = {"egnn": TE, "nequip": TN, "equiformer_v2": TQ}[arch]
    cls = {"egnn": TE.EGNN, "nequip": TN.NequIP,
           "equiformer_v2": TQ.EquiformerV2}[arch]
    jcfg = importlib.import_module(f"repro.configs.{arch}").SMOKE
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").SMOKE
    jb, tb = graph_pair(cfg.d_in, seed=4)
    target = np.random.default_rng(6).standard_normal((2, 1)).astype(
        np.float32)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(2))
    model = cls(cfg, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, jp))
    lw, gw = jax.value_and_grad(jmod.make_loss(jcfg))(
        jp, (jb, jnp.asarray(target)))
    gnn_grads_close(model, tmod.make_loss(model), jp, lw, gw,
                    (tb, torch.from_numpy(target)))


def test_pna_node_classification_loss_matches_reference():
    from tests.test_torch_pna import both_batches, random_batch
    from repro.configs.pna import SMOKE as J_SMOKE
    from repro_torch.configs.pna import SMOKE
    cfg, jcfg = (dataclasses.replace(c, n_out=5) for c in (SMOKE, J_SMOKE))
    feats, s, r, gid, e_cap = random_batch(11, 30, cfg.d_in, 3)
    jb, tb = both_batches(feats, s, r, gid, e_cap, 1)
    labels = np.random.default_rng(8).integers(0, 5, 11).astype(np.int32)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    model = TP.PNA(cfg, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, jp))
    lw, gw = jax.value_and_grad(JP.make_loss(jcfg))(
        jp, (jb, jnp.asarray(labels)))
    gnn_grads_close(model, TP.make_loss(model), jp, lw, gw,
                    (tb, torch.from_numpy(labels)))
