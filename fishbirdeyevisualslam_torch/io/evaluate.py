"""Trajectory evaluation: TUM parsing/writing and ATE RMSE — a copy of
``fishbirdeyevisualslam_tpu/io/evaluate.py`` for the port.

The reference's accuracy oracle is per-frame 2D ground truth drawn live plus a
TUM keyframe export for offline ATE (``System.cc:543-585``, SURVEY.md §4).  Here
the offline half is first-class: SE(2) Umeyama alignment (rotation+translation;
scale fixed to 1 — the system is metric thanks to odometry) and RMSE.
"""

from __future__ import annotations

import numpy as np
import torch

from fishbirdeyevisualslam_torch.geometry import se3


def align_se2(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Least-squares rigid 2D alignment est -> gt.  Returns (R 2x2, t 2)."""
    mu_e = est_xy.mean(0)
    mu_g = gt_xy.mean(0)
    E = est_xy - mu_e
    G = gt_xy - mu_g
    H = E.T @ G
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse_xy(est_xy: np.ndarray, gt_xy: np.ndarray, align: bool = True) -> float:
    """ATE RMSE on planar positions after optional rigid alignment."""
    assert est_xy.shape == gt_xy.shape and est_xy.ndim == 2
    if align and len(est_xy) >= 2:
        R, t = align_se2(est_xy, gt_xy)
        est_xy = est_xy @ R.T + t
    d = est_xy - gt_xy
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def relative_xy_from_Twb(Twb: np.ndarray) -> np.ndarray:
    """(N, 7) base poses (any world frame) -> (N, 2) planar positions relative to
    the first pose's base frame.  The SLAM world frame is the first CAMERA frame
    (tilted); expressing everything relative to the first BASE pose puts both the
    estimate and the SE2 ground truth in gravity-aligned frames."""
    Twb = torch.as_tensor(np.asarray(Twb, np.float32))
    rel = se3.compose(se3.inverse(Twb[0])[None, :], Twb)
    return rel[:, 4:6].numpy()


def relative_xy_from_se2(gt: np.ndarray) -> np.ndarray:
    """(N, 3) SE2 ground truth -> (N, 2) positions relative to the first pose."""
    x0, y0, th0 = gt[0]
    c, s = np.cos(th0), np.sin(th0)
    dx = gt[:, 0] - x0
    dy = gt[:, 1] - y0
    return np.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)


def ate_rmse_vs_gt(est_Twb: np.ndarray, gt_se2: np.ndarray, align: bool = True) -> float:
    """End-to-end ATE: estimated base trajectory vs SE2 ground truth, both
    re-expressed relative to their first pose."""
    return ate_rmse_xy(relative_xy_from_Twb(est_Twb), relative_xy_from_se2(gt_se2), align)


def parse_tum(text: str) -> np.ndarray:
    """TUM lines -> (N, 8) [t x y z qx qy qz qw]."""
    rows = []
    for line in text.strip().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        rows.append([float(v) for v in line.split()])
    return np.asarray(rows)
