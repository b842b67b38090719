"""Residuals + analytic pose Jacobians of the per-frame pose optimization —
the port of the front-reprojection and bird 3D-3D factors of
``fishbirdeyevisualslam_tpu/solvers/residuals.py`` (g2o edges
``EdgeSE3ProjectXYZOnlyPoseQuat`` and ``EdgeSE3ProjectBirdPoint2CamXYZ``,
``src/OdomG2oTypeQuat.cc``).

Pose = world-to-camera Tcw 7-vector; tangent (omega, upsilon), left
multiplicative, so d(T X)/dxi = [-[p]x | I] with p = T X.
"""

from __future__ import annotations

import torch

from fishbirdeyevisualslam_torch.config import CameraConfig
from fishbirdeyevisualslam_torch.geometry import se3


def point_jacobian_blocks(p):
    """(..., 3) camera-frame points -> (..., 3, 6) blocks [-[p]x | I]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    return torch.cat([-se3.skew(p), eye], dim=-1)


def front_residuals(cam: CameraConfig, Tcw, Xw, uv):
    """e = uv_obs - project(Tcw Xw) and its 2x6 pose Jacobian.
    Returns (e (N,2), J (N,2,6), p_cam (N,3))."""
    p = se3.transform(Tcw, Xw)
    x, y = p[..., 0], p[..., 1]
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
    u = cam.fx * x / z + cam.cx
    v = cam.fy * y / z + cam.cy
    e = uv - torch.stack([u, v], dim=-1)
    z2 = z * z
    zero = torch.zeros_like(z)
    Jep = -torch.stack(
        [
            torch.stack([cam.fx / z, zero, -cam.fx * x / z2], dim=-1),
            torch.stack([zero, cam.fy / z, -cam.fy * y / z2], dim=-1),
        ],
        dim=-2,
    )
    return e, Jep @ point_jacobian_blocks(p), p


def bird_residuals(Tcw, Xw, Xc):
    """e = Xc - Tcw Xw with pose Jacobian -[-[p]x | I].
    Returns (e (N,3), J (N,3,6), p_cam (N,3))."""
    p = se3.transform(Tcw, Xw)
    return Xc - p, -point_jacobian_blocks(p), p


def huber_weights(chi2, delta: float):
    """IRLS weight rho'(s): 1 inside the Huber region, delta/sqrt(s) outside."""
    return torch.where(chi2 <= delta * delta, 1.0,
                       delta / torch.sqrt(torch.clamp(chi2, min=1e-12)))
