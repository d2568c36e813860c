"""The port's step bundles (``repro_torch.launch.steps``) of the LM
family against the reference's (``repro.launch.steps``) on the CPU.

* Every LM smoke cell of ``tests/configs/test_smoke.py`` (five
  architectures x train_4k, prefill_32k, decode_32k, long_500k): the
  reference's ``make_host_args`` output goes through its jitted bundle
  function and, carried across by ``load_reference_args``, through the
  port's.  The SMOKE configurations are bfloat16, so each output leaf
  (loss, grad norm, updated parameters, AdamW moments; logits, caches)
  is held within a relative L2 of 3e-2 (the port's bfloat16 tolerance,
  ``tests/test_torch_train_loss.py``); ``lr``, ``skipped``, the step
  and the cache lengths exactly.  Two cases are held otherwise:

  - the MoE configurations run with a zero router in both packages, as
    ``test_torch_train_loss.py`` does in bfloat16: at the drawn router a
    one-ulp difference of a router input flips top-k choices;
  - a parameter that starts at zero (qwen2's biases, the zeroed
    router) is after the first step all update, ``-lr m / (sqrt(v) +
    eps)``: about +-lr an element, its sign the gradient's.  Where an
    element's gradient is rounding noise -- qwen2's key bias ``bk``,
    whose gradient is zero analytically (it shifts every score of a
    query by the same amount, which the softmax ignores), the zeroed
    router's near-ties -- that sign is arbitrary, so such a leaf is held
    within lr of zero in each package, and its moments (the gradient)
    within 3e-2 like every leaf's.

* Every LM cell at full size: each leaf of the abstract arguments lies
  on the meta device, ``model_flops`` equals the reference's exactly,
  the batch and cache leaves have its shapes and dtypes, the parameter
  tree its shapes and dtypes leaf by leaf, and the AdamW state its
  element count.

The helpers here serve the other ``test_torch_launch_*`` files too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as RS
from repro_torch.configs import get
from repro_torch.launch import steps as S

BF16_REL_L2 = 3e-2
_DTYPES = {"int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
           "float32": torch.float32, "bfloat16": torch.bfloat16}


def cells_of(family):
    return [(a, s) for a, s in S.all_cells() if get(a).family == family]


def ids(cells):
    return [f"{a}-{s}" for a, s in cells]


def paths(tree, pre=""):
    """{path: leaf} of a tree of dicts, lists, tuples, named tuples and
    dataclasses (their array fields), dict keys sorted, so the two
    packages' trees compare path by path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(paths(tree[k], f"{pre}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(paths(getattr(tree, k), f"{pre}/{k}"))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if v is not None and not isinstance(v, int):
                out.update(paths(v, f"{pre}/{f.name}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{pre}/{i}"))
        return out
    return {pre: tree}


def host(x) -> np.ndarray:
    """A leaf of either package as numpy; bfloat16 as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    norm = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return float(diff / norm) if norm else float(diff)


def run_both(arch, shape, prepare=None):
    """(reference output, port output, port arguments, the reference's
    arguments as numpy): the reference's host arguments through its
    jitted bundle function, and carried across by
    ``load_reference_args`` through the port's.  ``prepare`` edits the
    reference's arguments first (in both packages)."""
    args = RS.make_host_args(arch, shape)
    if prepare is not None:
        args = prepare(args)
    want = jax.jit(RS.make_bundle(arch, shape, smoke=True).get_fn())(*args)
    ref_args = jax.tree.map(np.asarray, args)
    got_args = S.load_reference_args(arch, shape, ref_args, device="cpu")
    got = S.make_bundle(arch, shape, smoke=True).get_fn()(*got_args)
    return jax.tree.map(np.asarray, want), got, got_args, ref_args


def torch_dtype(dtype):
    return _DTYPES[np.dtype(dtype).name]


def assert_meta(tree):
    for path, leaf in paths(tree).items():
        assert isinstance(leaf, torch.Tensor), path
        assert leaf.device.type == "meta", path


def shapes_dtypes(tree, int_map=None):
    """{path: (shape, torch dtype)}; ``int_map`` renames dtypes (the
    port's int64 graph indices for the reference's int32)."""
    out = {}
    for path, leaf in paths(tree).items():
        dt = leaf.dtype if isinstance(leaf, torch.Tensor) else \
            torch_dtype(leaf.dtype)
        out[path] = (tuple(leaf.shape), (int_map or {}).get(path, dt))
    return out


def numel(tree) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in paths(tree).values())


def assert_full_size_cell(arch, shape, data_arg_ids, int_map=None):
    """The full-size bundle is abstract and sized as the reference's;
    ``data_arg_ids`` are the positions of its batch / cache / index
    arguments, held leaf by leaf."""
    got = S.make_bundle(arch, shape)
    want = RS.make_bundle(arch, shape)
    assert got.name == want.name
    assert got.model_flops == want.model_flops
    assert len(got.abstract_args) == len(want.abstract_args) == \
        len(got.arg_specs)
    assert_meta(got.abstract_args)
    for i in data_arg_ids:
        assert shapes_dtypes(got.abstract_args[i]) == shapes_dtypes(
            want.abstract_args[i], int_map), (arch, shape, i)
    return got, want


# -------------------------------------------------------------------------
def zero_router(args):
    """The MoE configurations' router zeroed (module doc)."""
    params = dict(args[0])
    params["layers"] = dict(params["layers"])
    ffn = dict(params["layers"]["ffn"])
    ffn["router"] = ffn["router"] * 0
    params["layers"]["ffn"] = ffn
    return (params, *args[1:])


#: The zero-start leaves whose gradient is rounding noise (module doc):
#: qwen2's key bias and the zeroed router.
NOISE_GRAD_LEAVES = ("bk", "router")

LM_SMOKE = [(a, s) for a, s in cells_of("lm")]


@pytest.mark.parametrize("arch,shape", LM_SMOKE, ids=ids(LM_SMOKE))
def test_lm_smoke_cell_matches_reference(arch, shape):
    cfg = get(arch).smoke
    prepare = zero_router if cfg.is_moe else None
    want, got, got_args, _ = run_both(arch, shape, prepare)
    kind = get(arch).shapes[shape].kind
    W, G = paths(want), paths(got)
    assert W.keys() == G.keys()
    exact = {"/2/lr", "/2/skipped", "/1/step", "/1/lengths"}
    if kind == "train":
        lr = float(want[2]["lr"])
        old = paths(got_args[0])
    for path, w in W.items():
        g = host(G[path])
        assert g.shape == w.shape, path
        if path in exact:
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif kind == "train" and path.startswith("/0/") and \
                path.rsplit("/", 1)[-1] in NOISE_GRAD_LEAVES and \
                not host(old[path[2:]]).any():
            # a zero-start leaf whose gradient is rounding noise (module
            # doc): all update, of arbitrary sign
            for x in (g, w):
                assert np.abs(x).max() <= lr * 1.01, path
        else:
            assert rel_l2(g, w) <= BF16_REL_L2, (path, rel_l2(g, w))


LM_FULL = cells_of("lm")


@pytest.mark.parametrize("arch,shape", LM_FULL, ids=ids(LM_FULL))
def test_lm_full_size_cell_is_abstract_and_sized_as_reference(arch, shape):
    kind = get(arch).shapes[shape].kind
    data = {"train": (2,), "prefill": (1,), "decode": (1, 2)}[kind]
    got, want = assert_full_size_cell(arch, shape, data)
    # the parameter trees share the reference's layout: leaf by leaf
    assert shapes_dtypes(got.abstract_args[0]) == \
        shapes_dtypes(want.abstract_args[0])
    if kind == "train":
        assert numel(got.abstract_args[1]) == numel(want.abstract_args[1])
        assert got.arg_specs[2] == want.arg_specs[2]
