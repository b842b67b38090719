# Frozen copy of fishbirdeyevisualslam_torch/geometry/odometry.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Wheel-odometry SE(2) pre-integration — the port of
``fishbirdeyevisualslam_tpu/geometry/odometry.py`` (``src/Frame.cc:1049-1067``)."""

from __future__ import annotations

import torch

from portbench.reference.config import ExtrinsicsConfig
from portbench.reference.geometry import se3
from portbench.reference.geometry.ipm import extrinsics_Tbc, extrinsics_Tcb


def se2_to_se3(pose2d):
    """(x, y, theta) -> base-frame SE3 7-vector (rotation about z)."""
    x, y, theta = pose2d[..., 0], pose2d[..., 1], pose2d[..., 2]
    half = 0.5 * theta
    zero = torch.zeros_like(half)
    q = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
    t = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
    return se3.make(q, t)


def preintegrate_base(odom1, odom2):
    """Relative base motion T_b1_b2 from two planar odometry readings
    (``src/Frame.cc:1055-1058``)."""
    x1, y1, t1 = odom1[..., 0], odom1[..., 1], odom1[..., 2]
    x2, y2, t2 = odom2[..., 0], odom2[..., 1], odom2[..., 2]
    theta12 = t2 - t1
    dx, dy = x2 - x1, y2 - y1
    x12 = dx * torch.cos(t1) + dy * torch.sin(t1)
    y12 = dy * torch.cos(t1) - dx * torch.sin(t1)
    return se2_to_se3(torch.stack([x12, y12, theta12], dim=-1))


def preintegrate_cam(ext: ExtrinsicsConfig, odom1, odom2):
    """Relative camera motion T_c1_c2 = Tcb * T12b * Tbc (``src/Frame.cc:1065``)."""
    T12b = preintegrate_base(odom1, odom2)
    Tcb = extrinsics_Tcb(ext, T12b.dtype, T12b.device)
    Tbc = extrinsics_Tbc(ext, T12b.dtype, T12b.device)
    return se3.compose(se3.compose(Tcb, T12b), Tbc)


def motion_prior_Tcw(ext: ExtrinsicsConfig, Tcw_prev, odom_prev, odom_cur):
    """Odometry-seeded pose prior: Tcw_cur = T_c2_c1 * Tcw_prev
    (``Tracking.cc:1316-1320``)."""
    T_c1_c2 = preintegrate_cam(ext, odom_prev, odom_cur)
    return se3.compose(se3.inverse(T_c1_c2), Tcw_prev)
