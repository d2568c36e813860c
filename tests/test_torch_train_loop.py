"""The port's fault-tolerant loop (``repro_torch.train.loop``) against
the reference's (``repro.train.loop``) on the CPU, as
``tests/train/test_loop.py`` tests the reference:

* ``run`` on the reference's linear-regression problem and on DIEN at
  ``SMOKE``: the history (loss, grad_norm, lr, skipped) and the final
  parameters within rtol 1e-5 of the reference's run from the same
  parameters and batches (DIEN: rtol 1e-4, and an atol of 1e-5, a
  hundredth of the 1e-3 its parameters can move in 4 warmup steps:
  Adam's normalised step turns a gradient near ``eps`` that the two
  packages round apart into a different step);
* restart equivalence bitwise: ``FailAfter`` then a resume from the last
  committed checkpoint ends on the same bits as an uninterrupted run
  (linear regression, and DIEN through ``AsyncSaver`` and ``gc_old``);
  a resume from a checkpoint the reference wrote continues the
  reference's run;
* the NaN guard: the step is skipped (parameters and moments kept,
  ``step`` advanced, ``grad_norm`` NaN, ``lr`` 0, ``skipped`` 1), as the
  reference's;
* the straggler watchdog trips only once 5 steps set a baseline;
* ``run`` copies the caller's trees."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dien as JCD
from repro.models import dien as JD
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.configs import dien as TCD
from repro_torch.data.pipelines import dien_batch
from repro_torch.models import dien as D
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as L
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import flatten

OCFG = O.AdamWConfig(lr=0.05, warmup_steps=3, total_steps=40,
                     weight_decay=0.0)
J_OCFG = JO.AdamWConfig(lr=0.05, warmup_steps=3, total_steps=40,
                        weight_decay=0.0)


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def j_loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def np_data(step):
    rng = np.random.default_rng((7, step))
    x = rng.normal(size=(16, 4)).astype(np.float32)
    return {"x": x, "y": x @ np.arange(1, 5, dtype=np.float32)}


def data_fn(step):
    return {k: torch.from_numpy(v) for k, v in np_data(step).items()}


def j_data_fn(step):
    return {k: jnp.asarray(v) for k, v in np_data(step).items()}


def params0():
    return {"w": torch.zeros(4), "b": torch.zeros(())}


J_PARAMS0 = {"w": jnp.zeros((4,), jnp.float32), "b": jnp.zeros((), jnp.float32)}


def assert_bitwise(a_tree, b_tree):
    for a, b in zip(flatten(a_tree)[0], flatten(b_tree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def assert_history_close(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)


def test_run_matches_reference_on_linear_regression():
    lcfg = dict(total_steps=12, log_every=1)
    got, st, hist = L.run(params0(), loss_fn, data_fn, OCFG,
                          L.LoopConfig(**lcfg))
    want, jst, jhist = JL.run(J_PARAMS0, j_loss_fn, j_data_fn, J_OCFG,
                              JL.LoopConfig(**lcfg))
    assert_history_close(hist, jhist)
    for a, w in zip(flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    assert int(st.step) == int(jst.step) == 12


def dien_data(cfg, batch=8):
    def np_batch(step):
        return dien_batch(step, batch, cfg.seq_len, cfg.n_items, cfg.n_cates,
                          cfg.n_profile_vocab, seed=11)
    return (lambda s: {k: torch.from_numpy(v) for k, v in
                       np_batch(s).items()},
            lambda s: {k: jnp.asarray(v) for k, v in np_batch(s).items()})


def test_run_matches_reference_on_dien():
    jp = JD.init_params(JCD.SMOKE, jax.random.PRNGKey(5))
    tp = D.load_reference_params(jax.tree.map(np.asarray, jp), device="cpu")
    tdata, jdata = dien_data(TCD.SMOKE)
    ocfg, jocfg = O.AdamWConfig(lr=1e-2), JO.AdamWConfig(lr=1e-2)
    lcfg = dict(total_steps=4, log_every=1)
    got, _, hist = L.run(tp, D.make_train_loss(TCD.SMOKE), tdata, ocfg,
                         L.LoopConfig(**lcfg))
    want, _, jhist = JL.run(jp, JD.make_train_loss(JCD.SMOKE), jdata, jocfg,
                            JL.LoopConfig(**lcfg))
    assert_history_close(hist, jhist, rtol=1e-4)
    for a, w in zip(flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_restart_equivalence_is_bitwise(tmp_path):
    p_ref, s_ref, _ = L.run(params0(), loss_fn, data_fn, OCFG,
                            L.LoopConfig(total_steps=40))
    lcfg = L.LoopConfig(total_steps=40, ckpt_dir=str(tmp_path), ckpt_every=7)
    with pytest.raises(RuntimeError, match="injected failure at step 19"):
        L.run(params0(), loss_fn, data_fn, OCFG, lcfg,
              fail_after=L.FailAfter(20))
    assert C.latest_step(str(tmp_path)) == 14
    p2, s2, _ = L.run(params0(), loss_fn, data_fn, OCFG, lcfg)
    assert_bitwise(p2, p_ref)
    assert_bitwise(s2, s_ref)
    assert C.latest_step(str(tmp_path)) == 39


def test_dien_restart_equivalence_is_bitwise(tmp_path):
    tp = D.init_params(TCD.SMOKE, device="cpu")
    tdata, _ = dien_data(TCD.SMOKE)
    loss = D.make_train_loss(TCD.SMOKE)
    ocfg = O.AdamWConfig()
    p_ref, _, _ = L.run(tp, loss, tdata, ocfg, L.LoopConfig(total_steps=6))
    lcfg = L.LoopConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=1,
                        keep_ckpts=2)
    with pytest.raises(ValueError):
        L.run(tp, loss, tdata, ocfg, lcfg,
              fail_after=L.FailAfter(3, exc=ValueError))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000001", "step_000000002"]   # gc kept two
    p2, s2, _ = L.run(tp, loss, tdata, ocfg, lcfg)
    assert_bitwise(p2, p_ref)
    assert int(s2.step) == 6


def test_resume_from_a_reference_checkpoint(tmp_path):
    lcfg = dict(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=3)
    with pytest.raises(RuntimeError):
        JL.run(J_PARAMS0, j_loss_fn, j_data_fn, J_OCFG, JL.LoopConfig(**lcfg),
               fail_after=JL.FailAfter(5))
    assert C.latest_step(str(tmp_path)) == 3
    got, st, _ = L.run(params0(), loss_fn, data_fn, OCFG,
                       L.LoopConfig(**lcfg))
    want, _, _ = JL.run(J_PARAMS0, j_loss_fn, j_data_fn, J_OCFG,
                        JL.LoopConfig(total_steps=10))
    assert int(st.step) == 10
    for a, w in zip(flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_nan_guard_skips_update_as_the_reference():
    def bad_loss(params, batch):
        return torch.where(batch["bad"], torch.tensor(float("nan")),
                           torch.sum(params["w"] ** 2))

    def j_bad_loss(params, batch):
        return jnp.where(batch["bad"], jnp.float32(jnp.nan),
                         jnp.sum(params["w"] ** 2))

    step_fn = L.make_train_step(bad_loss, OCFG)
    j_step = JL.make_train_step(j_bad_loss, J_OCFG)
    params = {"w": torch.ones(3)}
    state = O.init(params, OCFG)
    jparams = {"w": jnp.ones((3,), jnp.float32)}
    jstate = JO.init(jparams, J_OCFG)
    for step in range(3):
        bad = step >= 1
        before = (params["w"].clone(), state.mu["w"].clone())
        params, state, s = step_fn(params, state,
                                   {"bad": torch.tensor(bad)})
        jparams, jstate, js = j_step(jparams, jstate,
                                     {"bad": jnp.asarray(bad)})
        assert int(s["skipped"]) == int(js["skipped"]) == int(bad)
        assert s["skipped"].dtype == torch.int32
        assert int(state.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(jparams["w"]), rtol=1e-6)
        if bad:
            assert torch.equal(params["w"], before[0])
            assert torch.equal(state.mu["w"], before[1])
            assert np.isnan(float(s["grad_norm"])) and \
                np.isnan(float(js["grad_norm"]))
            assert float(s["lr"]) == float(js["lr"]) == 0.0
            assert np.isnan(float(s["loss"]))
        else:
            np.testing.assert_allclose(float(s["grad_norm"]),
                                       float(js["grad_norm"]), rtol=1e-6)


def test_straggler_watchdog_trips_after_a_baseline():
    calls = {"n": 0}

    def slow_step(slow_call):
        def step(params, state, batch):
            calls["n"] += 1
            if calls["n"] == slow_call:
                import time
                time.sleep(0.4)
            return params, state, {"loss": torch.tensor(0.0)}
        return step

    lcfg = L.LoopConfig(total_steps=20, step_timeout_factor=3.0,
                        min_timeout_s=0.2)
    with pytest.raises(L.StragglerTimeout, match="step 8 took"):
        L.run(params0(), loss_fn, data_fn, OCFG, lcfg,
              train_step=slow_step(9))
    calls["n"] = 0                    # the first 5 steps set the baseline
    _, _, hist = L.run(params0(), loss_fn, data_fn, OCFG, lcfg,
                       train_step=slow_step(3))
    assert len(hist) == 2


def test_run_copies_the_callers_tree():
    p = params0()
    got, _, _ = L.run(p, loss_fn, data_fn, OCFG, L.LoopConfig(total_steps=3))
    assert not p["w"].any() and got["w"].any()
    assert got["w"].data_ptr() != p["w"].data_ptr()


def test_chip_smoke_recsys_and_train_phases_on_the_cpu(monkeypatch, tmp_path):
    """Phases R and T of ``chip_smoke.py`` on the CPU at ``SMOKE`` (the
    checks run CPU against CPU): every planted fault is caught, the
    restart is bitwise, and neither path launches a kernel."""
    import importlib
    import tempfile

    import chip_smoke
    from repro_torch.configs import common as CC
    from repro_torch.kernels import common
    for name in ("dien", "qwen2_1_5b", "egnn", "nequip", "equiformer_v2"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        monkeypatch.setattr(mod, "CONFIG", mod.SMOKE)
    for shape, dims in (("train_batch", dict(batch=12)),
                        ("serve_p99", dict(batch=8)),
                        ("serve_bulk", dict(batch=32)),
                        ("retrieval_cand", dict(batch=1, n_candidates=50))):
        monkeypatch.setitem(CC.RECSYS_SHAPES, shape, CC.ShapeSpec(
            shape, CC.RECSYS_SHAPES[shape].kind, dims))
    monkeypatch.setitem(CC.LM_SHAPES, "train_4k", CC.ShapeSpec(
        "train_4k", "train", dict(seq_len=16, global_batch=256)))
    monkeypatch.setitem(CC.GNN_SHAPES, "molecule", CC.ShapeSpec(
        "molecule", "molecule", dict(n_nodes=6, n_edges=10, batch=10,
                                     d_feat=4)))
    for key, value in dict(R_P99_CALLS=3, R_BULK_CALLS=2,
                           R_RETRIEVAL_CALLS=2, T_DIEN_CHECK_ROWS=8,
                           T_LM_BATCH=2, T_LM_STEPS=2, T_CHECK_BATCH=2,
                           T_CHECK_SEQ=12, T_GNN_STEPS=2,
                           GNN_CPU_MOLECULES=3).items():
        monkeypatch.setattr(chip_smoke, key, value)
    monkeypatch.setattr(chip_smoke, "fleet_dir",
                        lambda: tempfile.mkdtemp(dir=tmp_path))
    counts = chip_smoke.PathLaunches(
        {k: common.LaunchCounter(k) for k in chip_smoke.KERNEL_SOURCES})
    rec = chip_smoke.recsys_phase(counts, "the CPU", 0, device="cpu")
    p99 = rec["serve_p99"]
    assert p99["batch"] == 8 and p99["calls"] == 3
    assert p99["max_abs_err"] == 0.0
    assert p99["faults"]["augru_attention_one"] > chip_smoke.R_ATOL
    assert rec["serve_bulk"]["batch"] == 32
    retrieval = rec["retrieval_cand"]
    assert retrieval["max_abs_err"] == 0.0
    assert retrieval["faults"]["gru_ignores_mask"] > chip_smoke.R_ATOL
    out = chip_smoke.train_phase(counts, "the CPU", 0, device="cpu")
    dien = out["dien"]
    assert dien["batch"] == 12 and len(dien["loss"]) == 4
    assert dien["skipped"] == 0 and dien["check"]["max_abs_err"] == 0.0
    assert dien["check"]["fault_no_aux"] > chip_smoke.T_DIEN_ATOL
    for mode in ("deterministic", "default"):
        assert dien["restart"][mode]["bitwise"]
    assert dien["restart"]["default_run_equals_deterministic_run"]
    lm = out["qwen2-1.5b"]
    assert lm["reduced"] == ["global_batch 256->2"] and lm["seq"] == 16
    assert len(lm["loss"]) == 2 and lm["skipped"] == 0
    assert lm["check"]["rel_l2"] == 0.0
    assert lm["check"]["fault_no_causal_mask"] > chip_smoke.T_CHECK_REL_TOL
    assert lm["check"]["remat_bitwise"] and lm["bf16_peak_share"] > 0
    for arch in chip_smoke.GNN_ARCHS:
        g = out["gnn"][arch]
        assert len(g["loss"]) == 2 and g["check"]["max_abs_err"] == 0.0
    assert not any(counts.by_path["recsys"].values())
    assert not any(counts.by_path["train"].values())
    # the planted faults are caught by the check they target
    with chip_smoke.augru_attention_one(), pytest.raises(AssertionError,
                                                         match="fault"):
        chip_smoke.misses("t", lambda: torch.zeros(2), torch.zeros(2),
                          1e-4, 1e-5)
