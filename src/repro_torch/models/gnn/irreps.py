"""SO(3) irrep machinery for the equivariant GNNs (NequIP, Equiformer-v2).

Port of ``repro.models.gnn.irreps``, built from first principles:

* ``sph_harm``      -- real spherical harmonics up to l_max via the
                       associated-Legendre / (x+iy)^m recurrences
                       (orthonormal, Condon-Shortley folded in).
* ``cg_real``       -- real-basis Clebsch-Gordan tensors from the Racah
                       formula and the complex->real unitary: the same
                       numpy code as the reference's, so the same bits.
* ``wigner_d``      -- real Wigner D matrices per degree by the CG
                       recurrence D_l ~ proj(D_{l-1} (x) D_1); D_1 is the
                       rotation matrix in the real-SH (y, z, x) order.
* ``rot_to_polar``  -- per-edge rotation aligning a direction with the
                       polar axis (the eSCN frame; [Passaro & Zitnick,
                       arXiv:2302.03655]).

Feature convention: irrep features are ``[..., C, (l_max+1)^2]`` tensors
with uniform channel multiplicity C; the slice for degree l is
``[l^2 : (l+1)^2]`` with m ordered ``-l .. l``.

The CG tensors are numpy constants.  A model that applies them in every
layer keeps them as buffers on its device (:func:`wigner_cgs`), so no
constant crosses to the card inside a forward pass; the functions here
build them on the input's device when none are given.

Parity (as in the reference): SO(3) only; improper rotations are not
tracked.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


# -------------------------------------------------------------------------
# Real spherical harmonics.
# -------------------------------------------------------------------------
def num_comps(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slice(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def sph_harm(l_max: int, vecs: torch.Tensor, normalize: bool = True,
             eps: float = 1e-12) -> torch.Tensor:
    """Real orthonormal spherical harmonics of unit(ized) vectors.

    vecs: float[..., 3] (x, y, z).  Returns float[..., (l_max+1)^2]; the
    component order per l is m = -l..l.
    """
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    if normalize:
        r = torch.sqrt(x * x + y * y + z * z + eps)
        x, y, z = x / r, y / r, z / r

    # A_m = Re (x + i y)^m, B_m = Im (x + i y)^m    (sin^m(theta) folded in)
    A = [torch.ones_like(x)]
    B = [torch.zeros_like(x)]
    for m in range(1, l_max + 1):
        a_prev, b_prev = A[-1], B[-1]
        A.append(x * a_prev - y * b_prev)
        B.append(x * b_prev + y * a_prev)

    # Q_l^m: associated Legendre without the sin^m(theta) factor.
    Q = {}
    for m in range(l_max + 1):
        if m == 0:
            Q[(0, 0)] = torch.ones_like(z)
        else:
            # (2m-1)!! without the Condon-Shortley phase (the real SH
            # convention, so that Y_1 = sqrt(3/4pi) (y, z, x)).
            Q[(m, m)] = Q[(m - 1, m - 1)] * (2 * m - 1)
        if m + 1 <= l_max:
            Q[(m + 1, m)] = z * (2 * m + 1) * Q[(m, m)]
        for l in range(m + 2, l_max + 1):
            Q[(l, m)] = ((2 * l - 1) * z * Q[(l - 1, m)]
                         - (l - 1 + m) * Q[(l - 2, m)]) / (l - m)

    comps = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(l + 1):
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = k * Q[(l, 0)]
            else:
                row[l + m] = math.sqrt(2) * k * Q[(l, m)] * A[m]
                row[l - m] = math.sqrt(2) * k * Q[(l, m)] * B[m]
        comps.extend(row)
    return torch.stack(comps, dim=-1)


# -------------------------------------------------------------------------
# Clebsch-Gordan (complex, Racah formula) and the real-basis tensors:
# host-side numpy, the reference's code line for line.
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """<l1 m1 l2 m2 | l3 m3> as float64[2l1+1, 2l2+1, 2l3+1]."""
    f = math.factorial
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return out
    pref_l = math.sqrt(
        (2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = math.sqrt(
                f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2))
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                den = [k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                       l3 - l2 + m1 + k, l3 - l1 - m2 + k]
                if any(d < 0 for d in den):
                    continue
                s += (-1) ** k / np.prod([float(f(d)) for d in den])
            out[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return out


@functools.lru_cache(maxsize=None)
def _real_unitary(l: int) -> np.ndarray:
    """U[m_real, mu_complex]: real SH = U @ complex SH (CS phase)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    for m in range(-l, l + 1):
        i = m + l
        if m == 0:
            U[i, l] = 1.0
        elif m > 0:
            U[i, l + m] = (-1) ** m / math.sqrt(2)
            U[i, l - m] = 1 / math.sqrt(2)
        else:
            U[i, l + (-m)] = 1j * (-1) ** m / math.sqrt(2) * (-1)
            U[i, l - (-m)] = 1j / math.sqrt(2)
    return U


@functools.lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor w[m1, m2, m3], normalized so that
    contracting two unit irreps yields O(1) outputs.

    Equivariance: w . (D1 a) (x) (D2 b) == D3 (w . a (x) b).
    """
    C = _cg_complex(l1, l2, l3)
    U1, U2, U3 = _real_unitary(l1), _real_unitary(l2), _real_unitary(l3)
    # real = U @ complex  =>  w_real[i,j,k] = U1*[i,a] U2*[j,b] C[a,b,c] U3[k,c]
    w = np.einsum("ia,jb,abc,kc->ijk", U1.conj(), U2.conj(),
                  C.astype(complex), U3)
    re, im = np.real(w), np.imag(w)
    w = re if np.abs(re).max() >= np.abs(im).max() else im
    return np.ascontiguousarray(w)


def allowed_paths(l_in_max: int, l_f_max: int, l_out_max: int):
    """All (l1, l2, l3) triangle-admissible tensor-product paths."""
    paths = []
    for l1 in range(l_in_max + 1):
        for l2 in range(l_f_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_out_max) + 1):
                paths.append((l1, l2, l3))
    return paths


# -------------------------------------------------------------------------
# Wigner D matrices (real basis) from 3x3 rotation matrices.
# -------------------------------------------------------------------------
def wigner_cgs(l_max: int, dtype=torch.float32, device="cpu") -> list:
    """The coupling tensors of :func:`wigner_d`'s recurrence,
    ``cg_real(l - 1, 1, l)`` for l = 2..l_max, as tensors on
    ``device``."""
    return [torch.as_tensor(cg_real(l - 1, 1, l), dtype=dtype, device=device)
            for l in range(2, l_max + 1)]


def _d1_from_rot(R: torch.Tensor) -> torch.Tensor:
    """D_1 in the real-SH m=(-1,0,1) = (y, z, x) component order: rows
    and columns both permuted (x,y,z) -> (y,z,x)."""
    perm = [1, 2, 0]
    return R[..., perm, :][..., :, perm]


def wigner_d(l_max: int, R: torch.Tensor, cgs=None) -> list:
    """List of real Wigner D matrices [D_0, ..., D_{l_max}].

    R: float[..., 3, 3] rotation matrices.  The CG recurrence
    D_l = cg(l-1,1,l)^T . (D_{l-1} (x) D_1) . cg(l-1,1,l), exact for
    proper rotations; ``cgs`` are those tensors (:func:`wigner_cgs`),
    built on R's device when not given.
    """
    batch = tuple(R.shape[:-2])
    Ds = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return Ds
    if cgs is None:
        cgs = wigner_cgs(l_max, R.dtype, R.device)
    D1 = _d1_from_rot(R)
    Ds.append(D1)
    for l in range(2, l_max + 1):
        w = cgs[l - 2].to(R.dtype)                       # [2l-1, 3, 2l+1]
        n_in = 3 * (2 * l - 1)
        # E[..., m1, m2, n1, n2] = D_{l-1}[m1, n1] * D_1[m2, n2]
        big = Ds[l - 1][..., :, None, :, None] * D1[..., None, :, None, :]
        W = w.reshape(n_in, 2 * l + 1)
        # D = W^T . E . W with E flattened to [(m1, m2), (n1, n2)]; the
        # projection is exact (Racah CG are orthonormal per m3)
        D = W.transpose(0, 1) @ (big.reshape(batch + (n_in, n_in)) @ W)
        Ds.append(D)
    return Ds


def block_diag_wigner(l_max: int, R: torch.Tensor, cgs=None) -> torch.Tensor:
    """Dense [(L+1)^2, (L+1)^2] block-diagonal Wigner matrix."""
    Ds = wigner_d(l_max, R, cgs)
    n = num_comps(l_max)
    out = R.new_zeros(tuple(R.shape[:-2]) + (n, n))
    for l, D in enumerate(Ds):
        sl = l_slice(l)
        out[..., sl, sl] = D
    return out


def rot_to_polar(vec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rotation matrices R with R @ unit(vec) = (0, 0, 1) = z^.

    z is the polar axis of the real-SH convention: fixed-|m| component
    pairs mix under rotations about z, which is what makes the eSCN
    SO(2)-linear trick valid in this frame.  Rows are the orthonormal
    frame (t, b, v), det = +1.  The norms are sqrt(x + eps^2), as the
    reference's, so zero-length (padded) edges give finite frames.
    """
    v = vec / torch.sqrt((vec * vec).sum(dim=-1, keepdim=True) + eps * eps)
    # helper axis least aligned with v: e_x, or e_z when |v_x| >= 0.9
    # (built from the mask, so no constant crosses to the device)
    use_x = (v[..., 0].abs() < 0.9).to(vec.dtype)
    h = torch.stack([use_x, torch.zeros_like(use_x), 1 - use_x], dim=-1)
    t = torch.linalg.cross(h, v, dim=-1)
    t = t / torch.sqrt((t * t).sum(dim=-1, keepdim=True) + eps * eps)
    b = torch.linalg.cross(v, t, dim=-1)
    return torch.stack([t, b, v], dim=-2)  # det = +1 (proper rotation)


# -------------------------------------------------------------------------
# Equivariant feature helpers.
# -------------------------------------------------------------------------
def apply_wigner(l_max: int, Ds, feats: torch.Tensor) -> torch.Tensor:
    """feats [..., C, (L+1)^2] -> rotated feats (per-l block products:
    out[..., c, i] = sum_j D_l[..., i, j] feats[..., c, j])."""
    outs = []
    for l in range(l_max + 1):
        outs.append(feats[..., l_slice(l)] @ Ds[l].transpose(-1, -2))
    return torch.cat(outs, dim=-1)


def irrep_norms(l_max: int, feats: torch.Tensor,
                eps: float = 1e-12) -> torch.Tensor:
    """Per-(channel, l) L2 norms: [..., C, l_max+1]."""
    outs = []
    for l in range(l_max + 1):
        blk = feats[..., l_slice(l)]
        outs.append(torch.sqrt((blk * blk).sum(dim=-1) + eps))
    return torch.stack(outs, dim=-1)


def equivariant_rms_norm(l_max: int, feats: torch.Tensor,
                         gains: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalize each degree block over (channel, m); scale by gains.

    gains: [C, l_max+1]. l=0 keeps its mean (acts like RMSNorm).
    """
    outs = []
    for l in range(l_max + 1):
        blk = feats[..., l_slice(l)]                      # [..., C, 2l+1]
        ms = (blk * blk).mean(dim=(-1, -2), keepdim=True)
        blk = blk * torch.rsqrt(ms + eps)
        outs.append(blk * gains[..., :, l][..., None])
    return torch.cat(outs, dim=-1)


__all__ = ["allowed_paths", "apply_wigner", "block_diag_wigner", "cg_real",
           "equivariant_rms_norm", "irrep_norms", "l_slice", "num_comps",
           "rot_to_polar", "sph_harm", "wigner_cgs", "wigner_d"]
