"""The port's SO(3) irrep machinery (``repro_torch.models.gnn.irreps``)
against the reference (``repro.models.gnn.irreps``) on the CPU.

* ``cg_real`` (and the complex CG and the real unitary it is built from)
  for every path up to l 6: equal to the reference to the bit, as the
  port keeps its own copy of the same numpy code;
* ``sph_harm``, ``wigner_d`` at l_max 6, ``rot_to_polar``,
  ``apply_wigner``, ``block_diag_wigner``, ``irrep_norms`` and
  ``equivariant_rms_norm`` in float32 within rtol 1e-5 and atol 1e-6,
  on vectors that include the polar axis (both signs), |x| >= 0.9
  (the other helper axis) and zero length (padded edges);
* the port's own equivariance: ``sph_harm(R v) == D(R) sph_harm(v)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import irreps as JI
from repro_torch.models.gnn import irreps as TI

TOL = dict(rtol=1e-5, atol=1e-6)
L_MAX = 6


def vectors(n=40, seed=0):
    """float32 [n + 6, 3]: random vectors, then +-z (the polar axis), a
    vector with |x| >= 0.9 after normalising, a tiny one, and two of
    zero length."""
    r = np.random.default_rng(seed)
    special = np.array([[0, 0, 1], [0, 0, -2.5], [3, 0.1, -0.2],
                        [1e-7, -2e-7, 1e-7], [0, 0, 0], [0, 0, 0]])
    return np.concatenate([r.standard_normal((n, 3)) * 2,
                           special]).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


def rotations(n=6, seed=1):
    """float32 [n, 3, 3] proper rotations."""
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("l1", range(L_MAX + 1))
def test_cg_real_is_the_reference_to_the_bit(l1):
    for l2 in range(L_MAX + 1):
        np.testing.assert_array_equal(TI._real_unitary(l2),
                                      JI._real_unitary(l2))
        for l3 in range(abs(l1 - l2), min(l1 + l2, L_MAX) + 1):
            for fn in ("_cg_complex", "cg_real"):
                got = getattr(TI, fn)(l1, l2, l3)
                want = getattr(JI, fn)(l1, l2, l3)
                assert got.dtype == want.dtype and \
                    got.tobytes() == want.tobytes(), (fn, l1, l2, l3)
    assert TI.allowed_paths(2, 2, 2) == JI.allowed_paths(2, 2, 2)
    assert len(TI.allowed_paths(2, 2, 2)) == 15
    assert TI.num_comps(L_MAX) == JI.num_comps(L_MAX) == 49
    assert TI.l_slice(3) == JI.l_slice(3)


@pytest.mark.parametrize("normalize", [True, False])
def test_sph_harm_matches_reference(normalize):
    v = vectors()
    got = TI.sph_harm(L_MAX, torch.from_numpy(v), normalize=normalize)
    want = JI.sph_harm(L_MAX, jnp.asarray(v), normalize=normalize)
    assert got.dtype == torch.float32
    close(got, want)


def test_rot_to_polar_matches_reference():
    v = vectors()
    got = TI.rot_to_polar(torch.from_numpy(v))
    close(got, JI.rot_to_polar(jnp.asarray(v)))
    # a live edge's frame is a proper rotation mapping it onto +z (to
    # 1e-4: eps^2 in the norm shifts the 2.4e-7-long one by ~2e-5); a
    # zero-length edge's is finite (all zeros, as the reference's)
    live = torch.from_numpy(v[:-2])
    frames = got[:-2]
    eye = torch.eye(3).expand_as(frames)
    torch.testing.assert_close(frames @ frames.transpose(-1, -2), eye,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(torch.linalg.det(frames),
                               torch.ones(len(live)), atol=1e-4, rtol=0)
    unit = live / live.norm(dim=-1, keepdim=True)
    torch.testing.assert_close((frames @ unit[..., None])[..., 0],
                               torch.tensor([0.0, 0, 1]).expand_as(unit),
                               atol=1e-4, rtol=0)
    assert torch.isfinite(got).all()


def test_wigner_d_and_block_diag_match_reference():
    v = vectors()
    R = np.concatenate([rotations(), np.asarray(JI.rot_to_polar(
        jnp.asarray(v)))]).astype(np.float32)
    tr, jr = torch.from_numpy(R), jnp.asarray(R)
    got, want = TI.wigner_d(L_MAX, tr), JI.wigner_d(L_MAX, jr)
    assert len(got) == len(want) == L_MAX + 1
    for l, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (len(R), 2 * l + 1, 2 * l + 1)
        close(g, w)
    # the CG tensors passed as buffers give the same blocks
    cgs = TI.wigner_cgs(L_MAX)
    for g, w in zip(TI.wigner_d(L_MAX, tr, cgs), want):
        close(g, w)
    close(TI.block_diag_wigner(L_MAX, tr), JI.block_diag_wigner(L_MAX, jr))
    assert TI.wigner_d(0, tr)[0].shape == (len(R), 1, 1)


def test_apply_wigner_norms_and_rms_norm_match_reference():
    r = np.random.default_rng(3)
    R = rotations(5)
    feats = r.standard_normal((5, 7, 49)).astype(np.float32)
    gains = (1 + 0.1 * r.standard_normal((7, L_MAX + 1))).astype(np.float32)
    tD = TI.wigner_d(L_MAX, torch.from_numpy(R))
    jD = JI.wigner_d(L_MAX, jnp.asarray(R))
    tf, jf = torch.from_numpy(feats), jnp.asarray(feats)
    close(TI.apply_wigner(L_MAX, tD, tf), JI.apply_wigner(L_MAX, jD, jf))
    close(TI.irrep_norms(L_MAX, tf), JI.irrep_norms(L_MAX, jf))
    close(TI.equivariant_rms_norm(L_MAX, tf, torch.from_numpy(gains)),
          JI.equivariant_rms_norm(L_MAX, jf, jnp.asarray(gains)))
    # a rotation leaves every degree's norms where they were
    rot = TI.apply_wigner(L_MAX, tD, tf)
    torch.testing.assert_close(TI.irrep_norms(L_MAX, rot),
                               TI.irrep_norms(L_MAX, tf), rtol=1e-5,
                               atol=1e-5)


def test_sph_harm_is_equivariant_under_wigner_d():
    # unit-sized vectors: the eps in the norm bends the tiny ones
    v = torch.from_numpy(vectors()[:-3])
    R = torch.from_numpy(rotations(1))[0]
    Ds = TI.wigner_d(L_MAX, R)
    got = TI.sph_harm(L_MAX, v @ R.T)
    want = TI.apply_wigner(L_MAX, Ds, TI.sph_harm(L_MAX, v)[:, None, :])
    torch.testing.assert_close(got, want[:, 0], rtol=1e-4, atol=1e-5)
