# Frozen copy of fishbirdeyevisualslam_torch/geometry/ipm.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Inverse-perspective-mapped (IPM) bird's-eye view geometry — the port of
``fishbirdeyevisualslam_tpu/geometry/ipm.py``: bird pixel <-> metric base
ground plane (``src/Converter.cc:284-318``) and the static camera <-> base
extrinsics (``src/Frame.cc:1015-1047``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.config import BirdConfig, ExtrinsicsConfig
from portbench.reference.device import table
from portbench.reference.geometry import se3


def bird_pixel_to_base_xy(cfg: BirdConfig, pix):
    """Bird pixel (u=col, v=row) -> base-frame ground point (x fwd, y left, z=0)."""
    u, v = pix[..., 0], pix[..., 1]
    x = (cfg.rows / 2.0 - v) * cfg.pixel2meter + cfg.rear_axle_to_center
    y = (cfg.cols / 2.0 - u) * cfg.pixel2meter
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def base_xy_to_bird_pixel(cfg: BirdConfig, p):
    """Inverse mapping (``Converter::BaseXY2BirdPixel``)."""
    u = cfg.cols / 2.0 - p[..., 1] * cfg.meter2pixel
    v = cfg.rows / 2.0 - (p[..., 0] - cfg.rear_axle_to_center) * cfg.meter2pixel
    return torch.stack([u, v], dim=-1)


def _Tbc_numpy(ext: ExtrinsicsConfig) -> np.ndarray:
    qx, qy, qz, qw = ext.q_bc_xyzw
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    q = q / np.linalg.norm(q)
    return np.concatenate([q, np.asarray(ext.t_bc, np.float64)])


def extrinsics_Tbc(ext: ExtrinsicsConfig, dtype=torch.float32, device=None):
    """Pose of the camera in the base frame as a 7-vector."""
    return table(_Tbc_numpy, (ext,), dtype, torch.device("cpu" if device is None else device))


def extrinsics_Tcb(ext: ExtrinsicsConfig, dtype=torch.float32, device=None):
    return se3.inverse(extrinsics_Tbc(ext, dtype, device))


def base_xyz_to_cam(ext: ExtrinsicsConfig, p):
    """Base-frame 3D -> front-camera 3D (``Converter::BaseXY2CamXYZ``)."""
    return se3.transform(extrinsics_Tcb(ext, p.dtype, p.device), p)


def cam_xyz_to_base(ext: ExtrinsicsConfig, p):
    return se3.transform(extrinsics_Tbc(ext, p.dtype, p.device), p)


def Twb_from_Twc(ext: ExtrinsicsConfig, Twc):
    """Camera world pose -> base world pose: Twb = Twc * Tcb."""
    return se3.compose(Twc, extrinsics_Tcb(ext, Twc.dtype, Twc.device))


