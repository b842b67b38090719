# Frozen copy of fishbirdeyevisualslam_torch/solvers/pose_opt.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Single-pose Levenberg-Marquardt — the port of the plain (non-fused) route
of ``fishbirdeyevisualslam_tpu/solvers/pose_opt.py:pose_optimization``
(``Optimizer::PoseOptimizationWithBird``, ``src/Optimizer.cc:478-705``):

  * one SE3 vertex; front reprojection edges (info = invSigma2 * wF) and bird
    3D-3D edges (info = invSigma2 * wB), Huber delta sqrt(5.991);
  * 4 rounds x 10 iterations, rounds 0-2 restarting from the input pose with
    the current inlier set, Huber dropped from round 3 on;
  * after each round, re-gate on chi2 (front 1.5 * wF, bird 5.991 * wB);
  * an optional soft SE3 prior ``prior_info * ||log(T prior^-1)||^2``.

Every step is a tensor op with a fixed shape: steps are accepted or rejected
with ``torch.where``, so the 40 iterations never read a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.config import BAConfig, CameraConfig
from portbench.reference.geometry import se3
from portbench.reference.solvers import residuals as res


class FrontObs(NamedTuple):
    Xw: torch.Tensor          # (N, 3) world points
    uv: torch.Tensor          # (N, 2) undistorted keypoint positions
    inv_sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor       # (N,) bool


class BirdObs(NamedTuple):
    Xw: torch.Tensor          # (NB, 3) world points
    Xc: torch.Tensor          # (NB, 3) measured camera-frame points (IPM)
    inv_sigma2: torch.Tensor  # (NB,)
    valid: torch.Tensor       # (NB,) bool


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor
    front_inlier: torch.Tensor  # (N,) bool
    bird_inlier: torch.Tensor   # (NB,) bool
    n_inliers: torch.Tensor     # () int32 front inliers


def _chol_solve6(H, g):
    """Solve H x = g for a 6x6 SPD H: an unrolled Cholesky L L^T (diagonal
    clamped at 1e-12 before the square root) with forward and back
    substitution, a few tensor ops per column and no host read — unlike
    ``torch.linalg.cholesky``, which checks its ``info`` on the host once per
    LM iteration.  Each entry subtracts the earlier columns' products in the
    order of the JAX package's scalar unrolling."""
    dev = H.device
    eye = torch.eye(6, dtype=H.dtype, device=dev)
    below = torch.tril(torch.ones(6, 6, dtype=H.dtype, device=dev), -1)
    A = H
    cols = []
    for i in range(6):
        d = torch.sqrt(torch.clamp(A[i, i], min=1e-12))
        col = torch.where(below[:, i] > 0, A[:, i] / d, eye[:, i] * d)
        cols.append(col)
        low = col * below[:, i]
        A = torch.addr(A, low, low, alpha=-1.0)
    L = torch.stack(cols, dim=1)
    diag = torch.diagonal(L)
    b, y = g, []
    for i in range(6):  # L y = g
        y.append(b[i] / diag[i])
        b = b - L[:, i] * y[i]
    c, x = torch.stack(y), [None] * 6
    for i in reversed(range(6)):  # L^T x = y
        x[i] = c[i] / diag[i]
        c = c - L[i] * x[i]
    return torch.stack(x)


def _irls_weights(chi2, info, active, huber_delta, use_huber):
    """(Huber weight) * information * active, multiplied in the JAX package's order."""
    w = res.huber_weights(chi2, huber_delta) * info if use_huber else info
    return w * active


def _normal_terms(J, w, e):
    H = torch.einsum("nki,n,nkj->ij", J, w, J)
    b = torch.einsum("nki,n,nk->i", J, w, e)
    return H, -b


def _front_terms(cam, Tcw, front: FrontObs, w_front, huber_delta, use_huber, active):
    e, J, _ = res.front_residuals(cam, Tcw, front.Xw, front.uv)
    info = front.inv_sigma2 * w_front
    chi2 = torch.sum(e * e, dim=-1) * info
    H, g = _normal_terms(J, _irls_weights(chi2, info, active, huber_delta, use_huber), e)
    return H, g, chi2


def _bird_terms(Tcw, bird: BirdObs, w_bird, huber_delta, use_huber, active):
    e, J, _ = res.bird_residuals(Tcw, bird.Xw, bird.Xc)
    info = bird.inv_sigma2 * w_bird
    chi2 = torch.sum(e * e, dim=-1) * info
    H, g = _normal_terms(J, _irls_weights(chi2, info, active, huber_delta, use_huber), e)
    return H, g, chi2


def _robust_sum(chi2, act, huber_delta, use_huber):
    """Sum of the (Huber-robustified) chi2 over active edges, as g2o's chi2."""
    if use_huber:
        d2 = huber_delta ** 2
        chi2 = torch.where(chi2 > d2, 2.0 * huber_delta * torch.sqrt(torch.clamp(chi2, min=0)) - d2,
                           chi2)
    return torch.sum(chi2 * act)


def pose_optimization(cam: CameraConfig, ba: BAConfig, Tcw0, front: FrontObs, bird: BirdObs,
                      prior_T=None, prior_info: float = 0.0) -> PoseOptResult:
    """4x10 LM with chi2 re-gating (``Optimizer.cc:478-705``) plus the
    optional soft prior; ``prior_info = 0`` is the reference's behaviour."""
    f_in = front.valid
    b_in = bird.valid
    if prior_T is None:
        prior_T = Tcw0
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)
    prior_inv = se3.inverse(prior_T)

    def one_round(T_init, f_in, b_in, use_huber):
        f_act = f_in.to(torch.float32)
        b_act = b_in.to(torch.float32)

        def build_full(T):
            # one residual evaluation gives the normal equations AND the
            # robustified error; rejected steps reuse the last good H, g
            Hf, gf, c2f = _front_terms(cam, T, front, ba.w_front, ba.huber_delta, use_huber, f_act)
            Hb, gb, c2b = _bird_terms(T, bird, ba.w_bird, ba.huber_delta, use_huber, b_act)
            e = se3.log(se3.compose(T, prior_inv))
            err = (_robust_sum(c2f, f_act, ba.huber_delta, use_huber)
                   + _robust_sum(c2b, b_act, ba.huber_delta, use_huber)
                   + prior_info * torch.sum(e * e))
            return Hf + Hb + prior_info * eye6, gf + gb - prior_info * e, err

        T = T_init
        H, g, err = build_full(T)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=T.device)
        for _ in range(ba.pose_iters):
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
            dx = _chol_solve6(Hd, g)
            T_c = se3.retract(T, dx)
            H_c, g_c, err_c = build_full(T_c)
            accept = (err_c < err) & torch.all(torch.isfinite(dx))
            T = torch.where(accept, T_c, T)
            err = torch.where(accept, err_c, err)
            H = torch.where(accept, H_c, H)
            g = torch.where(accept, g_c, g)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        # re-gate at the optimized pose on the raw chi2 of every edge
        ef, _, _ = res.front_residuals(cam, T, front.Xw, front.uv)
        eb, _, _ = res.bird_residuals(T, bird.Xw, bird.Xc)
        chi2f = torch.sum(ef * ef, dim=-1) * (front.inv_sigma2 * ba.w_front)
        chi2b = torch.sum(eb * eb, dim=-1) * (bird.inv_sigma2 * ba.w_bird)
        f_new = front.valid & (chi2f <= ba.chi2_mono_pose * (ba.w_front + 1e-9))
        b_new = bird.valid & (chi2b <= ba.chi2_bird * (ba.w_bird + 1e-9))
        return T, f_new, b_new

    T = Tcw0
    for it in range(ba.pose_rounds):
        # rounds restart from the ORIGINAL pose with the refined inlier set
        # (Optimizer.cc:622); the last round keeps the previous round's pose
        T, f_in, b_in = one_round(Tcw0 if it < ba.pose_rounds - 1 else T, f_in, b_in, it < 3)
    n_enough = torch.sum(front.valid.to(torch.int32)) >= 3
    T = torch.where(n_enough, T, Tcw0)
    return PoseOptResult(T, f_in, b_in, torch.sum(f_in.to(torch.int32)).to(torch.int32))


