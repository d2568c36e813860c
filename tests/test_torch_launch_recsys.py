"""The port's step bundles of the recsys family (DIEN) against the
reference's on the CPU, in float32.

* Every DIEN smoke cell of ``tests/configs/test_smoke.py`` (train_batch,
  serve_p99, serve_bulk, retrieval_cand): the reference's
  ``make_host_args`` output through its jitted bundle function and,
  carried across by ``load_reference_args``, through the port's.  The
  loss, grad norm, every updated parameter and both AdamW moments (the
  gradients) within rtol 1e-4 / atol 1e-6, the port's DIEN tolerance;
  the logits and retrieval scores too; ``lr``, ``skipped`` and the step
  exactly.
* Every DIEN cell at full size: the abstract arguments lie on the meta
  device, ``model_flops`` equals the reference's exactly, and the
  parameters, the AdamW state and the batch (and candidates) have its
  shapes and dtypes leaf by leaf."""

import numpy as np
import pytest

from repro_torch.configs import get
from tests.test_torch_launch_lm import (assert_full_size_cell, cells_of,
                                        host, ids, paths, run_both,
                                        shapes_dtypes)

TOL = dict(rtol=1e-4, atol=1e-6)
RECSYS = cells_of("recsys")


@pytest.mark.parametrize("arch,shape", RECSYS, ids=ids(RECSYS))
def test_dien_smoke_cell_matches_reference(arch, shape):
    want, got, _, _ = run_both(arch, shape)
    W, G = paths(want), paths(got)
    assert W.keys() == G.keys()
    for path, w in W.items():
        g = host(G[path])
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path in ("/2/lr", "/2/skipped", "/1/step"):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, err_msg=path, **TOL)
    if get(arch).shapes[shape].kind == "retrieval":
        assert host(got).shape == (4, 64)


@pytest.mark.parametrize("arch,shape", RECSYS, ids=ids(RECSYS))
def test_dien_full_size_cell_is_abstract_and_sized_as_reference(arch, shape):
    got, want = assert_full_size_cell(arch, shape, ())
    for g, w in zip(got.abstract_args, want.abstract_args):
        assert shapes_dtypes(g) == shapes_dtypes(w)
