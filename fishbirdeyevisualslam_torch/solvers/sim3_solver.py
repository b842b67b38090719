"""Closed-form Sim3 / SE3 alignment with batched RANSAC — the port of
``fishbirdeyevisualslam_tpu/solvers/sim3_solver.py`` (the reference's
``Sim3Solver``, ``src/Sim3Solver.cc``): Horn's absolute orientation on
3-point minimal samples, every hypothesis computed and scored in one batch,
then a refit on all inliers.  ``fix_scale`` pins s = 1 (the reference's
default, ``src/System.cc:102``).

The samples are drawn by Gumbel-top-3, as in the JAX package: the noise
(n_iters, N) is an input, drawn on the host (``initializer.GumbelDraws``),
and equal keys go to the lower index, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fishbirdeyevisualslam_torch.device import pick
from fishbirdeyevisualslam_torch.geometry import se3, sim3
from fishbirdeyevisualslam_torch.solvers import linalg
from fishbirdeyevisualslam_torch.solvers.initializer import _samples


class Sim3Result(NamedTuple):
    S12: torch.Tensor       # (8,) similarity mapping frame-2 points into frame 1
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor  # () int32
    success: torch.Tensor   # () bool


def horn_sim3(p1, p2, w=None, fix_scale: bool = True):
    """The similarity S with p1 ~ s R p2 + t over matched 3D sets (..., N, 3)
    weighted by ``w`` (..., N), as (..., 8): Horn 1987 through the SVD of the
    weighted covariance (``Sim3Solver::ComputeSim3``)."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    c1 = torch.sum(p1 * w[..., None], dim=-2) / wsum[..., None]
    c2 = torch.sum(p2 * w[..., None], dim=-2) / wsum[..., None]
    q1, q2 = p1 - c1[..., None, :], p2 - c2[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", w, q2, q1)  # maps 2 -> 1
    U, S, Vt = torch.linalg.svd(H)
    V, Ut = Vt.mT, U.mT
    d = torch.sign(linalg.det3(V @ Ut))
    one = torch.ones_like(d)
    dD = torch.stack([one, one, d], dim=-1)
    R = V @ torch.diag_embed(dD) @ Ut
    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        var2 = torch.sum(w[..., None] * q2 * q2, dim=(-2, -1)) / wsum
        s = torch.sum(S * dD, dim=-1) / torch.clamp(var2 * wsum, min=1e-9)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return sim3.make(se3.matrix_to_quat(R), t, s[..., None])


def horn_alignment(p1, p2, w):
    """The rigid motion T with p1 ~ T p2 (scale fixed at 1), as a (..., 7) pose."""
    return sim3.to_se3(horn_sim3(p1, p2, w, fix_scale=True))


SIM3_INLIER_M = 0.3     # a pair is an inlier within this distance (m)
SIM3_MIN_INLIERS = 20   # a loop transform needs this many


def _inliers(S, p1, p2, valid, thresh: float):
    d = torch.linalg.vector_norm(p1 - sim3.transform(S[..., None, :], p2), dim=-1)
    return valid & (d < thresh)


def ransac_sim3(p1, p2, valid, gumbel, fix_scale: bool = True) -> Sim3Result:
    """Batched RANSAC over 3-point samples (one hypothesis per row of the
    (n_iters, N) Gumbel noise ``gumbel``), the best by inlier count (ties to
    the first), then a refit on its inliers; inliers within
    ``SIM3_INLIER_M``, success from ``SIM3_MIN_INLIERS``."""
    samples = _samples(valid, gumbel, 3).long()                  # (iters, 3)
    Ss = horn_sim3(p1[samples], p2[samples], fix_scale=fix_scale)
    counts = torch.sum(_inliers(Ss, p1[None], p2[None], valid[None], SIM3_INLIER_M)
                       .to(torch.int32), dim=1)
    S_best = pick(Ss, torch.argmax(counts))
    inl = _inliers(S_best, p1, p2, valid, SIM3_INLIER_M)
    S_ref = horn_sim3(p1, p2, inl.to(p1.dtype), fix_scale=fix_scale)
    inl2 = _inliers(S_ref, p1, p2, valid, SIM3_INLIER_M)
    n_in = torch.sum(inl2.to(torch.int32)).to(torch.int32)
    return Sim3Result(S_ref, inl2, n_in, n_in >= SIM3_MIN_INLIERS)
