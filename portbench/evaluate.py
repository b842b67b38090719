"""Trajectory arithmetic: a frozen copy of the SE2 arithmetic of
``fishbirdeyevisualslam_torch/io/evaluate.py`` (``align_se2``,
``ate_rmse_xy``, ``relative_xy_from_se2``), and the drift that the benchmark
reports as ``drift_pct``.
"""

from __future__ import annotations

import numpy as np

SEGMENT_M = 5.0   # drift_pct's segment length


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


def relative_xy_from_se2(gt: np.ndarray) -> np.ndarray:
    """(N, 3) SE2 ground truth -> (N, 2) positions relative to the first pose."""
    x0, y0, th0 = gt[0]
    c, s = np.cos(th0), np.sin(th0)
    dx = gt[:, 0] - x0
    dy = gt[:, 1] - y0
    return np.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)


def se2_matrix(pose) -> np.ndarray:
    """(3,) SE2 pose -> 4x4 homogeneous transform (z = 0, rotation about z)."""
    x, y, th = (float(v) for v in pose)
    c, s = np.cos(th), np.sin(th)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:2, 3] = [x, y]
    return T


def pose7_matrix(T7) -> np.ndarray:
    """(7,) pose [qw, qx, qy, qz, tx, ty, tz] -> 4x4 homogeneous transform."""
    w, x, y, z = (float(v) for v in T7[:4])
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = [float(v) for v in T7[4:7]]
    return T


def drift_pct(est_Twb: np.ndarray, gt_se2: np.ndarray, seg: float = SEGMENT_M):
    """KITTI odometry's translational error (Geiger, Lenz and Urtasun, 2012) on
    segments of ``seg`` metres: for every frame i with a later frame j at
    which the ground-truth path from i first reaches ``seg`` metres, the
    translation of inv(gt_i^-1 gt_j) (est_i^-1 est_j), divided by ``seg``;
    the mean over every such i, in percent.  ``est_Twb`` (N, 7) base poses in
    any world frame, ``gt_se2`` (N, 3) the same frames' ground truth.
    Returns (drift in %, number of segments); (None, 0) where no segment fits."""
    est = [pose7_matrix(T) for T in est_Twb]
    gt = [se2_matrix(p) for p in gt_se2]
    step = np.hypot(np.diff(gt_se2[:, 0]), np.diff(gt_se2[:, 1]))
    cum = np.concatenate([[0.0], np.cumsum(step)])
    errs = []
    for i in range(len(gt)):
        j = int(np.searchsorted(cum, cum[i] + seg, side="left"))
        if j >= len(gt):
            break
        d_gt = np.linalg.inv(gt[i]) @ gt[j]
        d_est = np.linalg.inv(est[i]) @ est[j]
        e = np.linalg.inv(d_gt) @ d_est
        errs.append(np.linalg.norm(e[:3, 3]) / seg)
    if not errs:
        return None, 0
    return 100.0 * float(np.mean(errs)), len(errs)
