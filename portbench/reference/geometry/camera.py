# Frozen copy of fishbirdeyevisualslam_torch/geometry/camera.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Front fisheye camera model — the port of
``fishbirdeyevisualslam_tpu/geometry/camera.py``: equidistant
(Kannala-Brandt k1..k4) distortion, pinhole projection on undistorted
coordinates (reference ``src/Frame.cc:638-669``)."""

from __future__ import annotations

import torch

from portbench.reference.config import CameraConfig


def project_pinhole(cam: CameraConfig, xyz):
    """Camera-frame 3D -> undistorted pixel (u, v); z <= 0 is the caller's to mask."""
    z = xyz[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * xyz[..., 0] / zs + cam.cx
    v = cam.fy * xyz[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1)


def _theta_d(cam: CameraConfig, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * cam.k4))))


def _theta_d_prime(cam: CameraConfig, theta):
    t2 = theta * theta
    return 1.0 + t2 * (3 * cam.k1 + t2 * (5 * cam.k2 + t2 * (7 * cam.k3 + t2 * 9 * cam.k4)))


def undistort_fisheye(cam: CameraConfig, uv_dist, iters: int = 10):
    """Distorted pixel -> undistorted pixel by ``iters`` Newton steps on theta
    (``cv::fisheye::undistortPoints`` semantics, ``src/Frame.cc:657``).  Theta
    is clamped just below pi/2 (1.565 rad, as the JAX package does) so rays at
    ~90 deg off-axis stay finite."""
    xd = (uv_dist[..., 0] - cam.cx) / cam.fx
    yd = (uv_dist[..., 1] - cam.cy) / cam.fy
    theta_d = torch.sqrt(xd * xd + yd * yd)
    theta = theta_d
    for _ in range(iters):
        f = _theta_d(cam, theta) - theta_d
        fp = _theta_d_prime(cam, theta)
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9, 1e-9, fp)
    theta = torch.clamp(theta, -1.565, 1.565)
    r = torch.tan(theta)
    small = theta_d < 1e-9
    scale = torch.where(small, 1.0, r / torch.where(small, 1.0, theta_d))
    u = cam.fx * xd * scale + cam.cx
    v = cam.fy * yd * scale + cam.cy
    return torch.stack([u, v], dim=-1)
