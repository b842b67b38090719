# Frozen copy of fishbirdeyevisualslam_torch/solvers/triangulate.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Batched two-view triangulation and its acceptance checks — the port of
``fishbirdeyevisualslam_tpu/solvers/triangulate.py`` (``Initializer::Triangulate``
and the gates of ``CheckRT`` / ``LocalMapping::CreateNewMapPoints``,
``src/LocalMapping.cc:231-476``).

The DLT rows are balanced to unit norm before the null vector is taken
(QR + SVD, ``solvers/linalg.py``), then two damped Gauss-Newton steps on the
two-view reprojection residual polish the point in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.config import CameraConfig
from portbench.reference.device import const
from portbench.reference.geometry import se3
from portbench.reference.solvers import linalg


class TriangulationResult(NamedTuple):
    Xw: torch.Tensor        # (N, 3) world points
    valid: torch.Tensor     # (N,) bool, every gate including parallax
    geom_ok: torch.Tensor   # (N,) bool, depth / reprojection / finite gates only
    parallax: torch.Tensor  # (N,) cos of the parallax angle


def _projection_rows(cam: CameraConfig, Tcw):
    """3x4 projection matrix K [R|t] of a pose 7-vector."""
    R = se3.quat_to_matrix(Tcw[..., :4])
    K = const(((cam.fx, 0.0, cam.cx), (0.0, cam.fy, cam.cy), (0.0, 0.0, 1.0)), Tcw.dtype,
              Tcw.device)
    return K @ torch.cat([R, Tcw[..., 4:, None]], dim=-1)


def _gn_step(cam: CameraConfig, X, views):
    """One damped Gauss-Newton step on the reprojection residuals of ``views``
    ((Tcw, R, uv) per view); rows whose step is not finite keep X."""
    H = torch.zeros(X.shape[:-1] + (3, 3), dtype=X.dtype, device=X.device)
    g = torch.zeros_like(X)
    for Tcw, R, uv in views:
        p = se3.transform(Tcw, X)
        z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
        eu = cam.fx * p[..., 0] / z + cam.cx - uv[..., 0]
        ev = cam.fy * p[..., 1] / z + cam.cy - uv[..., 1]
        zero = torch.zeros_like(z)
        ju = torch.einsum("...i,...ij->...j",
                          torch.stack([cam.fx / z, zero, -cam.fx * p[..., 0] / (z * z)], -1), R)
        jv = torch.einsum("...i,...ij->...j",
                          torch.stack([zero, cam.fy / z, -cam.fy * p[..., 1] / (z * z)], -1), R)
        H = H + ju[..., :, None] * ju[..., None, :] + jv[..., :, None] * jv[..., None, :]
        g = g + ju * eu[..., None] + jv * ev[..., None]
    lam = 1e-6 * (H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]) + 1e-12
    Hd = H + lam[..., None, None] * torch.eye(3, dtype=X.dtype, device=X.device)
    X_new = X - linalg.solve3(Hd, g)
    ok = torch.all(torch.isfinite(X_new), dim=-1)
    return torch.where(ok[..., None], X_new, X)


def triangulate(cam: CameraConfig, Tcw1, Tcw2, uv1, uv2, max_reproj_err: float = 4.0,
                min_parallax_cos: float = 0.99998) -> TriangulationResult:
    """DLT triangulation of N correspondences (undistorted pixels) seen from
    two poses; a batch of poses (..., 1, 7) triangulates every correspondence
    under each.  Accepted when finite, in front of both cameras, with parallax
    cos below ``min_parallax_cos`` and squared reprojection error below
    ``max_reproj_err`` in both views."""
    P1 = _projection_rows(cam, Tcw1)
    P2 = _projection_rows(cam, Tcw2)
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        rows += [uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                 uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]]
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)        # (..., N, 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    X_h = linalg.nullvec(A)
    w_ok = torch.abs(X_h[..., 3]) > 1e-9
    Xw = X_h[..., :3] / torch.where(w_ok[..., None], X_h[..., 3:], 1.0)

    views = ((Tcw1, se3.quat_to_matrix(Tcw1[..., :4]), uv1),
             (Tcw2, se3.quat_to_matrix(Tcw2[..., :4]), uv2))
    Xw = _gn_step(cam, _gn_step(cam, Xw, views), views)

    p1 = se3.transform(Tcw1, Xw)
    p2 = se3.transform(Tcw2, Xw)
    z_ok = (p1[..., 2] > 0) & (p2[..., 2] > 0)
    r1 = Xw - se3.inverse(Tcw1)[..., 4:]
    r2 = Xw - se3.inverse(Tcw2)[..., 4:]
    cosp = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1) + 1e-12)

    def reproj_err(p, uv):
        z = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        u = cam.fx * p[..., 0] / z + cam.cx
        v = cam.fy * p[..., 1] / z + cam.cy
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2

    e_ok = (reproj_err(p1, uv1) < max_reproj_err) & (reproj_err(p2, uv2) < max_reproj_err)
    finite = torch.all(torch.isfinite(Xw), dim=-1)
    geom_ok = w_ok & z_ok & e_ok & finite
    return TriangulationResult(Xw, geom_ok & (cosp < min_parallax_cos), geom_ok, cosp)
