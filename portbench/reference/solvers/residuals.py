# Frozen copy of fishbirdeyevisualslam_torch/solvers/residuals.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
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

from portbench.reference.config import CameraConfig
from portbench.reference.geometry import se3


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


def front_point_jacobian(cam: CameraConfig, Tcw, Xw):
    """2x3 Jacobian of the front residual with respect to the world point,
    jacobian_e_p @ R (``EdgeSE3ProjectXYZ2UVQuat::linearizeOplus``,
    ``src/OdomG2oTypeQuat.cc:109-129``)."""
    p = se3.transform(Tcw, Xw)
    x, y = p[..., 0], p[..., 1]
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
    z2 = z * z
    zero = torch.zeros_like(z)
    Jep = -torch.stack(
        [
            torch.stack([cam.fx / z, zero, -cam.fx * x / z2], dim=-1),
            torch.stack([zero, cam.fy / z, -cam.fy * y / z2], dim=-1),
        ],
        dim=-2,
    )
    return Jep @ se3.quat_to_matrix(Tcw[..., :4])


def bird_point_jacobian(Tcw, Xw):
    """3x3 Jacobian of the bird residual with respect to the world point: -R
    (``EdgeSE3ProjectXYZ2XYZQuat::linearizeOplus``, ``.cc:157-169``)."""
    R = se3.quat_to_matrix(Tcw[..., :4])
    shape = torch.broadcast_shapes(Xw.shape[:-1], Tcw.shape[:-1]) + (3, 3)
    return (-R).expand(shape)


def odom_residuals(T_meas, T1, T2):
    """SE3 relative-pose residual e = log(m^-1 T1 T2^-1) with the reference's
    Jacobians (``EdgeSE3Quat::linearizeOplus``, ``src/OdomG2oTypeQuat.cc:191-204``):
    J1 = JRInv(e) Adj(T2) Adj(T1^-1), J2 = -JRInv(e).
    Returns (e (N,6), J1 (N,6,6), J2 (N,6,6))."""
    e = se3.relative_error(T_meas, T1, T2)
    Jr = se3.jr_inv_approx(e)
    J1 = Jr @ se3.adjoint(T2) @ se3.adjoint(se3.inverse(T1))
    return e, J1, -Jr


def front_error(cam: CameraConfig, Tcw, Xw, uv):
    """The front reprojection residual alone.  Returns (e (N,2), p_cam (N,3))."""
    p = se3.transform(Tcw, Xw)
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
    u = cam.fx * p[..., 0] / z + cam.cx
    v = cam.fy * p[..., 1] / z + cam.cy
    return uv - torch.stack([u, v], dim=-1), p


def bird_error(Tcw, Xw, Xc):
    """The bird 3D-3D residual alone.  Returns (e (N,3), p_cam (N,3))."""
    p = se3.transform(Tcw, Xw)
    return Xc - p, p
