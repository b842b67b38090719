"""Batched RANSAC PnP for relocalization — the port of
``fishbirdeyevisualslam_tpu/solvers/pnp.py`` (the reference's EPnP + RANSAC,
``src/PnPsolver.cc``, ``Tracking.cc:2231-2392``).

``_epnp_pose`` is EPnP (Lepetit et al.; ``PnPsolver.cc:375-860``) in closed
form over any leading batch: 4 control points from the principal axes,
barycentric coordinates, the 12-column null space, the N=1/2/3 beta
initialisations and 6 joint Gauss-Newton steps on the four betas
(``gauss_newton``, ``PnPsolver.cc:741``; the Jacobian of the distance
residuals is written out), the best of the three by reprojection error.  All
RANSAC hypotheses (minimal set 4) run in one batch; the winner is refit on
all its inliers twice (``PnPsolver::Refine``).

Every small solve is batched on the card: the null space goes through the
Householder QR of ``solvers/linalg.py`` and a square SVD (the minimal set's
8 x 12 system padded with zero rows; its exact 4-dimensional null space
then takes a basis fixed by the span alone, ``_canonical_basis``, not the
SVD's own), the 3 x 3 inverse is closed form and the 3-5 unknown normal
equations take ``linalg.spd_solve``.  The samples are drawn by
Gumbel-top-4 with the noise as an input, as ``ransac_sim3``.

The control points lie on the principal axes of the points, which
``torch.linalg.eigh`` fixes up to their signs only; LAPACK (the CPU, as the
JAX package on the CPU) and cuSOLVER (the card) choose other signs, so the
card runs EPnP on mirrored control points and its hypotheses and refits
differ from the CPU's within the measurement noise
(``scripts/pnp_card_vs_cpu.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import CameraConfig
from fishbirdeyevisualslam_torch.device import const, pick
from fishbirdeyevisualslam_torch.geometry import se3, sim3
from fishbirdeyevisualslam_torch.solvers import linalg
from fishbirdeyevisualslam_torch.solvers.initializer import _samples, _square
from fishbirdeyevisualslam_torch.solvers.sim3_solver import horn_sim3


class PnPResult(NamedTuple):
    Tcw: torch.Tensor        # (7,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    success: torch.Tensor    # () bool


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


# four fixed generic directions of R^12 (a seeded draw) that pick the basis
# of a 4-dimensional null space
_BASIS_SEEDS = tuple(map(tuple, np.random.RandomState(0).randn(4, 12).round(6).tolist()))


def _canonical_basis(vs):
    """A basis of the span of ``vs`` (..., 4, 12) that depends on the span
    only: the orthonormalised projections of four fixed directions onto it.
    A minimal set's 8 x 12 system has an exact 4-dimensional null space, of
    which an SVD returns some basis of its own (LAPACK, cuSOLVER and the
    JAX package's each another), and EPnP's beta initialisations depend on
    the basis; this one is the same on every device."""
    E = const(_BASIS_SEEDS, vs.dtype, vs.device)                      # (4, 12)
    X = torch.einsum("...ki,...kj,bj->...bi", vs, vs, E)              # rows: P e_b
    out = []
    for b in range(4):   # Gram-Schmidt in order
        x = X[..., b, :]
        for q in out:
            x = x - torch.sum(x * q, dim=-1, keepdim=True) * q
        out.append(x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                                   min=1e-30))
    return torch.stack(out, dim=-2)


def _epnp_pose(cam: CameraConfig, Xw, uv, w=None):
    """EPnP from >= 4 correspondences (..., m, 3) / (..., m, 2); returns Tcw
    (..., 7).  ``w`` (..., m): weights; zero rows drop out of every solve,
    which is how the all-inlier refit runs at a fixed shape."""
    m = Xw.shape[-2]
    if w is None:
        w = torch.ones(Xw.shape[:-1], dtype=Xw.dtype, device=Xw.device)
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    # 4 control points: centroid + principal axes (choose_control_points)
    c0 = torch.sum(Xw * w[..., None], dim=-2) / wsum[..., None]
    Xc = (Xw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = Xc.mT @ Xc / wsum[..., None, None]
    w_eval, w_evec = torch.linalg.eigh(cov)  # ascending
    k = torch.sqrt(torch.clamp(w_eval, min=1e-10))
    cws = torch.stack([c0, c0 + k[..., 2:3] * w_evec[..., :, 2],
                       c0 + k[..., 1:2] * w_evec[..., :, 1],
                       c0 + k[..., 0:1] * w_evec[..., :, 0]], dim=-2)    # (..., 4, 3)
    # barycentric coordinates (compute_barycentric_coordinates)
    CC = (cws[..., 1:, :] - cws[..., :1, :]).mT
    CCinv = linalg.inv3(CC + 1e-9 * torch.eye(3, dtype=CC.dtype, device=CC.device))
    a123 = (Xw - cws[..., :1, :]) @ CCinv.mT
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)  # (..., m, 4)

    # M (fill_M): 2 rows per point, 12 columns (4 control points x 3)
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(u)
    Mu = torch.cat([torch.stack([alphas[..., j] * cam.fx, zeros, alphas[..., j] * (cam.cx - u)],
                                -1) for j in range(4)], dim=-1)
    Mv = torch.cat([torch.stack([zeros, alphas[..., j] * cam.fy, alphas[..., j] * (cam.cy - v)],
                                -1) for j in range(4)], dim=-1)
    M = torch.cat([Mu, Mv], dim=-2) * torch.cat([w, w], dim=-1)[..., None]   # (..., 2m, 12)
    # a degenerate sample (control points in a plane) overflows M; its pose
    # is NaN, which no inlier gate accepts, as in the JAX package, whose
    # SVD passes NaN through where torch's stops
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
    M = torch.where(bad[..., None, None], 0.0, M)
    vs = linalg.smallest_right_singular_vectors(_square(M), 4)
    if 2 * m <= 8:
        vs = _canonical_basis(vs)
    vs = vs.reshape(vs.shape[:-2] + (4, 4, 3))   # (..., null vector, control point, xyz)

    dw2 = torch.stack([torch.sum((cws[..., i, :] - cws[..., j, :]) ** 2, -1) for i, j in _PAIRS],
                      dim=-1)                                              # (..., 6)
    dv = torch.stack([vs[..., :, i, :] - vs[..., :, j, :] for i, j in _PAIRS], dim=-3)
    # dv (..., 6 pairs, 4 null vectors, 3)

    def resid_jac(beta):
        diff = torch.einsum("...k,...pkj->...pj", beta, dv)
        r = torch.sum(diff * diff, dim=-1) - dw2
        return r, 2.0 * torch.einsum("...pj,...pkj->...pk", diff, dv)

    def dots(a, b):
        return torch.sum(dv[..., a, :] * dv[..., b, :], dim=-1)

    # beta initialisations (find_betas_approx_1/2/3)
    zero = torch.zeros_like(wsum)
    dv0n2 = dots(0, 0)
    b1 = torch.sum(torch.sqrt(dw2) * torch.sqrt(dv0n2), -1) / torch.clamp(dv0n2.sum(-1), min=1e-12)
    beta_a = torch.stack([b1, zero, zero, zero], dim=-1)
    # N=2: unknowns (b11, b12, b22)
    L2 = torch.stack([dots(0, 0), 2.0 * dots(0, 1), dots(1, 1)], dim=-1)     # (..., 6, 3)
    eye = lambda n: torch.eye(n, dtype=Xw.dtype, device=Xw.device)
    b2v = linalg.spd_solve(L2.mT @ L2 + 1e-9 * eye(3), (L2.mT @ dw2[..., None])[..., 0])
    bb1 = torch.sqrt(torch.abs(b2v[..., 0]))
    bb2 = torch.sqrt(torch.abs(b2v[..., 2])) * torch.sign(b2v[..., 1]) * torch.sign(b2v[..., 0])
    beta_b = torch.stack([bb1, bb2, zero, zero], dim=-1)
    # N=3: unknowns (b11, b12, b22, b13, b23)
    L3 = torch.stack([dots(0, 0), 2.0 * dots(0, 1), dots(1, 1), 2.0 * dots(0, 2),
                      2.0 * dots(1, 2)], dim=-1)                            # (..., 6, 5)
    b3v = linalg.spd_solve(L3.mT @ L3 + 1e-9 * eye(5), (L3.mT @ dw2[..., None])[..., 0])
    cb1 = torch.sqrt(torch.abs(b3v[..., 0]))
    cb2 = torch.sqrt(torch.abs(b3v[..., 2])) * torch.sign(b3v[..., 1]) * torch.sign(b3v[..., 0])
    cb3 = torch.where(torch.abs(cb1) > 1e-12, b3v[..., 3] / torch.clamp(2.0 * cb1, min=1e-12),
                      0.0) * torch.sign(b3v[..., 0])
    beta_c = torch.stack([cb1, cb2, cb3, zero], dim=-1)

    # the three initialisations side by side on a new axis (..., 3, ...)
    beta = torch.stack([beta_a, beta_b, beta_c], dim=-2)
    dv, dw2 = dv[..., None, :, :, :], dw2[..., None, :]
    for _ in range(6):   # joint Gauss-Newton over all 4 betas (gauss_newton)
        r, J = resid_jac(beta)
        H = J.mT @ J + 1e-9 * eye(4)
        beta = beta - linalg.spd_solve(H, (J.mT @ r[..., None])[..., 0])
    cc = torch.einsum("...k,...kij->...ij", beta, vs[..., None, :, :, :])   # (..., 3, 4, 3)
    pc = alphas[..., None, :, :] @ cc                                        # (..., 3, m, 3)
    wb = w[..., None, :]
    pc = pc * torch.sign(torch.sum(pc[..., 2] * wb, dim=-1))[..., None, None]
    bad3 = bad[..., None] | ~torch.isfinite(pc).all(dim=-1).all(dim=-1)
    pc = torch.where(bad3[..., None, None], 0.0, pc)
    T = sim3.to_se3(horn_sim3(pc, Xw[..., None, :, :], wb.expand(pc.shape[:-1]),
                              fix_scale=True))                               # (..., 3, 7)
    T = torch.where(bad3[..., None], torch.nan, T)
    errs = torch.sum(_reproj_err(cam, T[..., None, :], Xw[..., None, :, :],
                                 uv[..., None, :, :]) * wb, dim=-1)
    best = torch.argmin(errs, dim=-1)   # a NaN error wins, as in the JAX package
    return torch.take_along_dim(T, best[..., None, None], dim=-2)[..., 0, :]


def _reproj_err(cam: CameraConfig, Tcw, Xw, uv):
    p = se3.transform(Tcw, Xw)
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
    u = cam.fx * p[..., 0] / z + cam.cx
    v = cam.fy * p[..., 1] / z + cam.cy
    return torch.where(p[..., 2] > 0, (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2, 1e12)


PNP_CHI2 = 5.991       # chi2 (2 dof, 95%) of the reference's RANSAC parameters
PNP_MIN_INLIERS = 10


def ransac_pnp(cam: CameraConfig, Xw, uv, valid, gumbel) -> PnPResult:
    """RANSAC as the reference's ``SetRansacParameters(0.99, 10, 300, 4, 0.5,
    5.991)`` (``Tracking.cc:2276``): one EPnP hypothesis per row of the
    (n_iters, N) Gumbel noise ``gumbel`` on 4-point samples, the best by
    inlier count (ties to the first) under a generous 4 x chi2 gate, then two
    all-inlier refits, each kept only where it loses no inlier; success from
    10 inliers."""
    gate = PNP_CHI2 * 4.0
    samples = _samples(valid, gumbel, 4).long()                     # (iters, 4)
    Ts = _epnp_pose(cam, Xw[samples], uv[samples])
    counts = torch.sum((valid[None] & (_reproj_err(cam, Ts[:, None, :], Xw[None], uv[None])
                                       < gate)).to(torch.int32), dim=1)
    T = pick(Ts, torch.argmax(counts))
    inl = valid & (_reproj_err(cam, T, Xw, uv) < gate)
    n_in = torch.sum(inl.to(torch.int32))
    for _ in range(2):
        T_r = _epnp_pose(cam, Xw, uv, w=inl.to(Xw.dtype))
        inl_r = valid & (_reproj_err(cam, T_r, Xw, uv) < gate)
        n_r = torch.sum(inl_r.to(torch.int32))
        better = n_r >= n_in
        T = torch.where(better, T_r, T)
        inl = torch.where(better, inl_r, inl)
        n_in = torch.where(better, n_r, n_in)
    n_in = n_in.to(torch.int32)
    return PnPResult(T, inl, n_in, n_in >= PNP_MIN_INLIERS)
