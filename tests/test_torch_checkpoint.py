"""The port's checkpoint layer (``repro_torch.train.checkpoint``) against
the JAX package's (``repro.train.checkpoint``): the same leaf order for
nested dicts, lists, tuples, named tuples and ``None``; checkpoints
written by either package restored by the other byte for byte; and the
reference's protocol behaviour (async failures re-raised, the
``LATEST``-keyed gc window, typed errors), as
``tests/train/test_checkpoint.py`` checks it."""

import collections
import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JC
from repro_torch.train import checkpoint as C

Pair = collections.namedtuple("Pair", "left right")


def _nested(seed=0):
    """Nested dicts (keys out of order), lists, tuples, a named tuple,
    an OrderedDict, ``None`` leaves and several dtypes."""
    rng = np.random.default_rng(seed)
    return {
        "z": rng.integers(0, 100, (4,)).astype(np.int64),
        "a": [rng.standard_normal((2, 3)).astype(np.float32), None,
              (rng.integers(0, 9, (3,)).astype(np.int32),
               {"y": np.int64(seed), "b": None,
                "c": rng.integers(0, 2, (2, 2)).astype(np.bool_)})],
        "m": Pair(rng.standard_normal(5), rng.integers(0, 7, ())
                  .astype(np.int16)),
        "o": collections.OrderedDict([("q", np.arange(3, dtype=np.uint8)),
                                      ("p", np.arange(2.0))]),
        "none": None,
    }


def _as_torch(tree):
    leaves, td = C.flatten(tree)
    return C.unflatten(td, [torch.from_numpy(np.asarray(x)) for x in leaves])


def _host_leaves(tree):
    leaves, _ = C.flatten(tree)
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in leaves]


def _assert_same(got, want):
    g, w = _host_leaves(got), _host_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_flatten_matches_jax_leaf_order_and_treedef():
    tree = _nested()
    want, jtd = jax.tree.flatten(tree)
    got, td = C.flatten(tree)
    assert len(got) == len(want)
    assert all(a is b for a, b in zip(got, want))
    assert str(td) == str(jtd)
    back = C.unflatten(td, got)
    assert back["a"][1] is None and isinstance(back["a"][2], tuple)
    assert isinstance(back["m"], Pair) and isinstance(
        back["o"], collections.OrderedDict)
    assert list(back["o"]) == ["q", "p"]
    with pytest.raises(ValueError, match="more leaves"):
        C.unflatten(td, got + [np.zeros(1)])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _nested(1)
    JC.save(str(tmp_path), 4, tree, metadata={"n": 3})
    got, step, meta = C.restore(str(tmp_path), _nested(2), device="cpu")
    assert (step, meta) == (4, {"n": 3})
    _assert_same(got, tree)
    assert isinstance(got["z"], torch.Tensor) and got["z"].device.type == "cpu"
    assert C.manifest(str(tmp_path)) == JC.manifest(str(tmp_path))
    # a torch template restores too, dtype from the template
    tgot, _, _ = C.restore(str(tmp_path), _as_torch(_nested(2)),
                           device="cpu")
    _assert_same(tgot, tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _as_torch(_nested(3))
    C.save(str(tmp_path), 7, tree, metadata={"version": 7})
    got, step, meta = JC.restore(str(tmp_path), _nested(0))
    assert (step, meta) == (7, {"version": 7})
    _assert_same(got, tree)
    with open(os.path.join(tmp_path, "step_000000007",
                           "manifest.json")) as f:
        man = json.load(f)
    assert man["treedef"] == str(jax.tree.flatten(_nested())[1])
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000007"]


def test_async_saver_copies_on_the_caller_thread(tmp_path):
    """A host tensor written after ``AsyncSaver.save`` returns does not
    reach the checkpoint: its bytes were copied on the caller thread."""
    x = torch.arange(6, dtype=torch.int64)
    saver = C.AsyncSaver()
    saver.save(str(tmp_path), 0, {"x": x, "skip": None})
    x.fill_(-1)
    saver.wait()
    got, _, _ = JC.restore(str(tmp_path), {"x": np.zeros(6, np.int64)})
    np.testing.assert_array_equal(np.asarray(got["x"]), np.arange(6))


@pytest.mark.parametrize("when", ["wait", "next_save"])
def test_async_saver_reraises_background_failure(tmp_path, when):
    saver = C.AsyncSaver()
    blocked = tmp_path / "blocked"
    blocked.write_text("a file, not a directory")
    saver.save(str(blocked), 0, {"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="NOT durable") as ei:
        if when == "wait":
            saver.wait()
        else:
            saver.save(str(tmp_path / "ok"), 1, {"a": np.zeros(2)})
    assert ei.value.__cause__ is not None
    saver.save(str(tmp_path / "ok2"), 2, {"a": np.zeros(2)})
    saver.wait()
    assert C.latest_step(str(tmp_path / "ok2")) == 2


def test_gc_window_is_keyed_off_latest_like_the_reference(tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    for path, mod in ((ours, C), (theirs, JC)):
        for step in range(6):
            mod.save(path, step, {"a": np.full(2, step)})
        with open(os.path.join(path, "LATEST"), "w") as f:
            f.write("1")
        mod.gc_old(path, keep=2)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "LATEST", "step_000000001", "step_000000004", "step_000000005"]
    C.gc_old(str(tmp_path / "missing"))            # no directory: no-op


def test_typed_errors(tmp_path):
    path = str(tmp_path)
    with pytest.raises(FileNotFoundError) as ei:
        C.restore(path, {"a": np.zeros(2)}, device="cpu")
    assert not isinstance(ei.value, C.SnapshotGoneError)
    assert C.latest_step(path) is None
    C.save(path, 0, {"a": np.zeros(2)})
    C.save(path, 1, {"a": np.ones(2)})
    shutil.rmtree(os.path.join(path, "step_000000000"))
    with pytest.raises(C.SnapshotGoneError, match="step 0") as ei:
        C.restore(path, {"a": np.zeros(2)}, step=0, device="cpu")
    assert ei.value.step == 0
    with pytest.raises(C.SnapshotGoneError, match="step 0"):
        C.manifest(path, step=0)
    os.remove(os.path.join(path, "step_000000001", "arrays.npz"))
    with pytest.raises(C.SnapshotGoneError, match="arrays.npz"):
        C.restore(path, {"a": np.zeros(2)}, device="cpu")
    C.save(path, 2, {"a": np.ones(2)})
    npz = os.path.join(path, "step_000000002", "arrays.npz")
    data = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(data[: len(data) // 3])
    with pytest.raises(C.CheckpointCorruptError, match="step 2"):
        C.restore(path, {"a": np.zeros(2)}, device="cpu")
    C.save(path, 3, {"a": np.ones(2)})
    with open(os.path.join(path, "step_000000003", "manifest.json"),
              "w") as f:
        f.write("{not json")
    with pytest.raises(C.CheckpointCorruptError, match="manifest.json"):
        C.manifest(path)
    C.save(path, 4, {"a": np.ones(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        C.restore(path, {"a": np.ones(2)}, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore(path, {"a": np.ones(2), "b": np.ones(4)}, device="cpu")


def test_bfloat16_leaves_name_the_training_slice(tmp_path):
    """bfloat16 leaves (the training slice's) save and restore bit for
    bit, also into a float32 template (converted as ``.to`` converts)."""
    w = torch.randn(3, 4).to(torch.bfloat16)
    C.save(str(tmp_path), 0, {"w": w, "f": torch.ones(2)})
    got, _, _ = C.restore(str(tmp_path), {"w": torch.zeros(3, 4,
                                                          dtype=torch.bfloat16),
                                          "f": torch.zeros(2)}, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    as32, _, _ = C.restore(str(tmp_path), {"w": torch.zeros(3, 4),
                                           "f": torch.zeros(2)}, device="cpu")
    assert torch.equal(as32["w"], w.float())
    assert C.manifest(str(tmp_path))["dtypes"] == ["float32", "bfloat16"]


def _train_state_pair():
    """The same (params, OptState) tree in both packages: bfloat16 and
    float32 parameters, float32 moments, an int32 step."""
    from repro.train import optimizer as JO
    from repro_torch.models.common import load_tree
    from repro_torch.train import optimizer as O
    rng = np.random.default_rng(3)
    params = {"emb": jax.numpy.asarray(rng.standard_normal((5, 3)),
                                       jax.numpy.bfloat16),
              "layers": [{"w": jax.numpy.asarray(
                  rng.standard_normal((3, 3)), jax.numpy.float32)}],
              "ln": jax.numpy.asarray(rng.standard_normal(3) + 1,
                                      jax.numpy.bfloat16)}
    cfg = JO.AdamWConfig()
    grads = jax.tree.map(lambda x: x * 0.5, params)
    params, state, _ = JO.apply(params, grads, JO.init(params, cfg), cfg)
    jtree = (params, state)
    ttree = (load_tree(jax.tree.map(np.asarray, params), device="cpu"),
             O.load_reference_state(jax.tree.map(np.asarray, state),
                                    device="cpu"))
    return jtree, ttree


def _members(path, step):
    import zipfile
    with zipfile.ZipFile(os.path.join(path, f"step_{step:09d}",
                                      "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bfloat16_train_state_bytes_match_the_reference(tmp_path):
    """The port writes a (params, OptState) tree with bfloat16 leaves as
    the reference does: the same npz members byte for byte (a bfloat16
    leaf under the npy descr '<V2'), the same manifest."""
    jtree, ttree = _train_state_pair()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JC.save(jdir, 7, jtree, metadata={"k": 1})
    C.save(tdir, 7, ttree, metadata={"k": 1})
    want, got = _members(jdir, 7), _members(tdir, 7)
    assert got == want
    assert b"'descr': '<V2'" in got["0.npy"]
    assert C.manifest(tdir) == JC.manifest(jdir)
    assert C.manifest(tdir)["dtypes"][:3] == ["bfloat16", "float32",
                                              "bfloat16"]
    saver = C.AsyncSaver()                     # the async path writes the same
    saver.save(tdir, 8, ttree, metadata={"k": 1})
    saver.wait()
    assert _members(tdir, 8) == want


def test_port_restores_a_reference_bfloat16_checkpoint_bitwise(tmp_path):
    jtree, ttree = _train_state_pair()
    JC.save(str(tmp_path), 2, jtree)
    zeros = C.unflatten(C.flatten(ttree)[1], [torch.zeros_like(x) for x in
                                              C.flatten(ttree)[0]])
    got, step, _ = C.restore(str(tmp_path), zeros, device="cpu")
    assert step == 2 and type(got[1]).__name__ == "OptState"
    for a, b in zip(C.flatten(got)[0], C.flatten(ttree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_restore_of_its_own_bfloat16_checkpoint_raises(tmp_path):
    """A fault of the reference the port does not copy: its ``restore``
    casts the void '<V2' array to bfloat16, which numpy cannot do."""
    tree = {"w": jax.numpy.arange(4, dtype=jax.numpy.bfloat16)}
    JC.save(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="No cast function available"):
        JC.restore(str(tmp_path), tree)
    got, _, _ = C.restore(str(tmp_path), {"w": torch.zeros(
        4, dtype=torch.bfloat16)}, device="cpu")
    assert got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_restore_defaults_to_the_card(tmp_path):
    C.save(str(tmp_path), 0, {"a": np.zeros(2)})
    if torch.cuda.is_available():
        got, _, _ = C.restore(str(tmp_path), {"a": np.zeros(2)})
        assert got["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            C.restore(str(tmp_path), {"a": np.zeros(2)})


def test_concurrent_async_savers_commit_every_step(tmp_path):
    """Two savers into two directories from two threads: each commits
    all of its steps (one in flight at a time per saver)."""
    def run(path):
        saver = C.AsyncSaver()
        for step in range(4):
            saver.save(path, step, {"a": np.full(3, step)})
        saver.wait()
    paths = [str(tmp_path / f"d{i}") for i in range(2)]
    threads = [threading.Thread(target=run, args=(p,)) for p in paths]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    for p in paths:
        got, step, _ = JC.restore(p, {"a": np.zeros(3, np.int64)})
        assert step == 3
        np.testing.assert_array_equal(np.asarray(got["a"]), [3, 3, 3])
