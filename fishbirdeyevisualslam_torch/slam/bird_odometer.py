"""Standalone bird's-eye-view odometer — the port of
``fishbirdeyevisualslam_tpu/slam/bird_odometer.py`` (a demo pipeline; the
SLAM never calls it).

The reference ships ``edge_filter_ipm`` + ``simple_birdseye_odometer`` as a
self-contained 2D scan-matching odometry over IPM edge clouds
(``src/edge_filter_ipm.cpp``, ``src/simple_birdseye_odometer.cpp``; pclomp
NDT with key-cloud updates at 1 m / 5 deg).  Here: gradient-edge extraction
on the bird image, then a fixed count of SE2 registration iterations against
a key cloud — NDT (voxel Gaussians by scatter-sums, damped Gauss-Newton over
the voxel and its 4 face neighbours) or point-to-point ICP (all-pairs nearest
neighbours and closed-form SE2 updates) — in plain PyTorch on the device of
the images, with no host read inside a registration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import const, resolve_device, upload
from fishbirdeyevisualslam_torch.ops.edge_filter import filter_ipm_edges, sqrt_f32


class EdgeCloud(NamedTuple):
    xy: torch.Tensor     # (N, 2) base-frame ground coordinates
    valid: torch.Tensor  # (N,) bool


# The JAX package's edge clouds and grids are jitted, and XLA's CPU compiler
# contracts each a * b + c there into one fused multiply-add.  Where that
# rounding decides a result this module must equal (the cloud, the grid),
# the same products are fused here by ``torch.addcmul``, which fuses on the
# CPU and on the card alike.


def _grad_mag(img):
    gy = img[2:, 1:-1] - img[:-2, 1:-1]
    gx = img[1:-1, 2:] - img[1:-1, :-2]
    return torch.nn.functional.pad(sqrt_f32(torch.addcmul(gy * gy, gx, gx)), (1, 1, 1, 1))


def _top_cloud(score, width: int, cfg: SystemConfig, n_points: int):
    """The ``n_points`` highest scores (ties to the lower flat index, as
    ``lax.top_k`` breaks them) as bird pixels mapped to the base frame
    (``ipm.bird_pixel_to_base_xy`` with its multiply-add fused)."""
    v, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    v, idx = v[:n_points], idx[:n_points]
    u, r = (idx % width).to(torch.float32), (idx // width).to(torch.float32)
    b = cfg.bird
    x = torch.addcmul(torch.full_like(r, b.rear_axle_to_center), b.rows / 2.0 - r,
                      torch.full_like(r, b.pixel2meter))
    y = (b.cols / 2.0 - u) * b.pixel2meter
    return v, torch.stack([x, y], -1)


def edge_cloud_filtered(bird_img, freespace_img, cfg: SystemConfig,
                        n_points: int = 1024) -> EdgeCloud:
    """Reference-fidelity edge extraction: the full ``EdgeFilterIPM`` pipeline
    (``ops/edge_filter.py``) -> top-n surviving pixels -> metric base frame.
    ``freespace_img``: the freespace intensity image (mask * 255 works)."""
    merged, _, _ = filter_ipm_edges(bird_img, freespace_img)
    # equal weights are ordered by gradient magnitude
    g = _grad_mag(bird_img)
    score = merged * 1e4 + torch.where(merged > 0, g, torch.zeros_like(g))
    v, xy = _top_cloud(score, bird_img.shape[1], cfg, n_points)
    return EdgeCloud(xy, v > 0.0)


def edge_cloud(bird_img, mask, cfg: SystemConfig, n_points: int = 1024) -> EdgeCloud:
    """Gradient-magnitude edge extraction -> top-n edge pixels -> metric base
    frame (the fast path; ``edge_cloud_filtered`` is the ``EdgeFilterIPM``
    analog)."""
    g = _grad_mag(bird_img)
    g = torch.where(mask > 0, g, torch.zeros_like(g))
    v, xy = _top_cloud(g, bird_img.shape[1], cfg, n_points)
    return EdgeCloud(xy, v > 10.0)


def _se2_fit(p_ref, p_cur, w):
    """Weighted closed-form SE2 aligning cur -> ref: (tx, ty, theta)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_r = torch.sum(p_ref * w[:, None], dim=0) / wsum
    mu_c = torch.sum(p_cur * w[:, None], dim=0) / wsum
    qr = p_ref - mu_r
    qc = p_cur - mu_c
    sxx = torch.sum(w * (qc[:, 0] * qr[:, 0] + qc[:, 1] * qr[:, 1]))
    sxy = torch.sum(w * (qc[:, 0] * qr[:, 1] - qc[:, 1] * qr[:, 0]))
    th = torch.atan2(sxy, sxx)
    c, s = torch.cos(th), torch.sin(th)
    t = mu_r - torch.stack([c * mu_c[0] - s * mu_c[1], s * mu_c[0] + c * mu_c[1]])
    return t[0], t[1], th


def icp_se2(ref: EdgeCloud, cur: EdgeCloud, init_xyt, n_iters: int = 12,
            max_corr: float = 0.5):
    """Fixed-iteration point-to-point ICP: returns (x, y, theta), a (3,)
    tensor, mapping the current cloud into the reference frame."""
    x, y, th = init_xyt[0], init_xyt[1], init_xyt[2]
    big = torch.full((), 1e9, dtype=torch.float32, device=cur.xy.device)
    for _ in range(n_iters):
        c, s = torch.cos(th), torch.sin(th)
        moved = torch.stack([c * cur.xy[:, 0] - s * cur.xy[:, 1] + x,
                             s * cur.xy[:, 0] + c * cur.xy[:, 1] + y], dim=-1)
        d2 = torch.sum((moved[:, None, :] - ref.xy[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(ref.valid[None, :], d2, big)
        nnd, nn = torch.min(d2, dim=1)
        w = (cur.valid & (nnd < max_corr ** 2)).to(torch.float32)
        x, y, th = _se2_fit(ref.xy[nn], cur.xy, w)
    return torch.stack([x, y, th])


# ---------------------------------------------------------------------------
# NDT registration (the pclomp::NormalDistributionsTransform analog;
# ``simple_birdseye_odometer.cpp:35-38`` runs DIRECT7 NDT — in 2D the
# neighbourhood is the centre voxel + 4 face neighbours, "DIRECT5")
# ---------------------------------------------------------------------------

NDT_GRID = 32          # voxels per side (covers the bird-view footprint)
NDT_EXTENT = 12.0      # meters: grid spans [-NDT_EXTENT, NDT_EXTENT]^2
NDT_MIN_PTS = 3        # voxels with fewer points carry no distribution


class NDTGrid(NamedTuple):
    mu: torch.Tensor       # (G*G, 2) voxel means
    inv_cov: torch.Tensor  # (G*G, 2, 2) inverse covariances (regularized)
    ok: torch.Tensor       # (G*G,) bool: enough points for a distribution


def _voxel_id(xy):
    cell = 2.0 * NDT_EXTENT / NDT_GRID
    ij = torch.floor((xy + NDT_EXTENT) / cell).to(torch.int64)
    inside = torch.all((ij >= 0) & (ij < NDT_GRID), dim=-1)
    ij = torch.clamp(ij, 0, NDT_GRID - 1)
    return ij[:, 0] * NDT_GRID + ij[:, 1], inside


def _det2(cov):
    """det of (N, 2, 2) matrices as the jitted JAX package rounds it."""
    return torch.addcmul(-(cov[:, 0, 1] * cov[:, 1, 0]), cov[:, 0, 0], cov[:, 1, 1])


def build_ndt_grid(cloud: EdgeCloud) -> NDTGrid:
    """Voxel Gaussians by scatter-sums (the NDT target-cells build).
    Covariances are regularized the pclomp way: eigenvalues floored at 1% of
    the largest, plus an absolute floor of (cell/10)^2 (edge points lie on
    near-perfect lines, and a zero cross-line variance shrinks the
    attraction basin to nothing)."""
    xy = cloud.xy
    dev = xy.device
    vid, inside = _voxel_id(xy)
    w = (cloud.valid & inside).to(torch.float32)
    n = NDT_GRID * NDT_GRID
    cnt = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, vid, w)
    sx = torch.zeros((n, 2), dtype=torch.float32, device=dev).index_add_(0, vid, xy * w[:, None])
    mu = sx / torch.clamp(cnt, min=1.0)[:, None]
    d = xy - mu[vid]
    outer = d[:, :, None] * d[:, None, :] * w[:, None, None]
    cov = torch.zeros((n, 2, 2), dtype=torch.float32, device=dev).index_add_(0, vid, outer) \
        / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    # eigen-floor regularization (2x2 closed form)
    tr = cov[:, 0, 0] + cov[:, 1, 1]
    det = _det2(cov)
    disc = sqrt_f32(torch.clamp(torch.addcmul(-det, 0.25 * tr, tr), min=0.0))
    lam_max = torch.clamp(torch.addcmul(disc, tr, torch.full_like(tr, 0.5)), min=1e-4)
    cell = 2.0 * NDT_EXTENT / NDT_GRID
    floor = torch.addcmul(torch.full_like(tr, (0.1 * cell) ** 2), lam_max,
                          torch.full_like(tr, 0.01))
    cov = torch.addcmul(cov, floor[:, None, None],
                        const(((1.0, 0.0), (0.0, 1.0)), torch.float32, dev)[None])
    det2 = _det2(cov)
    inv = torch.stack([
        torch.stack([cov[:, 1, 1], -cov[:, 0, 1]], -1),
        torch.stack([-cov[:, 1, 0], cov[:, 0, 0]], -1),
    ], -2) / torch.clamp(det2, min=1e-12)[:, None, None]
    return NDTGrid(mu, inv, cnt >= NDT_MIN_PTS)


# DIRECT5 neighbourhood: centre + 4 face neighbours
_NBR = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
_INFLATION = (16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 1, 1)


def ndt_se2(grid: NDTGrid, cur: EdgeCloud, init_xyt, n_iters: int = 12):
    """Fixed-iteration damped Gauss-Newton NDT registration: returns (x, y,
    theta), a (3,) tensor, mapping the current cloud into the grid's frame.

    Per Magnusson's NDT each transformed point scores against the Gaussian
    of its voxel (+4 neighbours); the Hessian is the Gauss-Newton PSD part
    weighted by the Gaussian robust factor exp(-0.5 e' S e).  A coarse-to-fine
    covariance inflation (16x -> 1x over the iterations) widens the
    attraction basin the way multi-resolution NDT does.  Each step solves
    the damped 3x3 system with ``torch.linalg.solve_ex`` (no error check, so
    no host read)."""
    dev = cur.xy.device
    cell = 2.0 * NDT_EXTENT / NDT_GRID
    eye3 = const(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), torch.float32, dev)
    px, py = cur.xy[:, 0], cur.xy[:, 1]
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    x, y, th = init_xyt[0], init_xyt[1], init_xyt[2]
    for infl in _INFLATION[:n_iters]:
        c, s = torch.cos(th), torch.sin(th)
        mx = c * px - s * py + x
        my = s * px + c * py + y
        moved = torch.stack([mx, my], -1)
        # Jacobian of the moved point with respect to (x, y, th): (N, 2, 3)
        J = torch.stack([
            torch.stack([one, zero, -s * px - c * py], -1),
            torch.stack([zero, one, c * px - s * py], -1),
        ], -2)
        H = torch.zeros((3, 3), dtype=torch.float32, device=dev)
        g = torch.zeros((3,), dtype=torch.float32, device=dev)
        ij = torch.floor((moved + NDT_EXTENT) / cell).to(torch.int64)
        for di, dj in _NBR:
            ii, jj = ij[:, 0] + di, ij[:, 1] + dj
            inb = (ii >= 0) & (ii < NDT_GRID) & (jj >= 0) & (jj < NDT_GRID)
            vid = torch.clamp(ii, 0, NDT_GRID - 1) * NDT_GRID + torch.clamp(jj, 0, NDT_GRID - 1)
            e = moved - grid.mu[vid]                          # (N, 2)
            S = grid.inv_cov[vid] / float(infl)               # (N, 2, 2)
            Se = torch.einsum("nij,nj->ni", S, e)
            m2 = torch.sum(e * Se, dim=-1)                    # Mahalanobis^2
            wgt = torch.exp(-0.5 * torch.clamp(m2, max=50.0))
            wgt = wgt * (cur.valid & inb & grid.ok[vid]).to(torch.float32)
            JtSe = torch.einsum("nij,ni->nj", J, Se)          # (N, 3)
            JtSJ = torch.einsum("nij,nik,nkl->njl", J, S, J)
            g = g - torch.sum(wgt[:, None] * JtSe, dim=0)
            H = H + torch.sum(wgt[:, None, None] * JtSJ, dim=0)
        dx = torch.linalg.solve_ex(H + 1e-3 * eye3, g)[0]
        # a step clamp in place of pclomp's line search
        dx = torch.clamp(dx, -0.5, 0.5)
        x, y, th = x + dx[0], y + dx[1], th + dx[2]
    return torch.stack([x, y, th])


class BirdOdometer:
    """``SimpleBirdseyeOdometer`` analog: accumulate the SE2 pose by
    registering each frame's edge cloud to a key cloud; the key cloud is
    refreshed at 1 m / 5 deg.  The pose bookkeeping is numpy (float64) on
    the host; the clouds and registrations run on ``device`` (the card
    unless the caller names the CPU), with one host read per frame.

    ``method``: "ndt" (default — the reference's pclomp NDT) or "icp"
    (point-to-point)."""

    def __init__(self, cfg: SystemConfig, method: str = "ndt",
                 use_edge_filter: bool = False, device=None):
        self.cfg = cfg
        self.method = method
        # full EdgeFilterIPM fidelity (Otsu-Canny + focal-ray artifact
        # removal) vs the fast gradient-top-k path
        self.use_edge_filter = use_edge_filter
        self.device = resolve_device(device)
        self.key_cloud = None
        self.key_grid = None
        self.key_pose = np.zeros(3)   # world pose of the key cloud
        self.pose = np.zeros(3)       # current world SE2 pose

    def _cloud(self, bird_img, mask) -> EdgeCloud:
        img = upload(torch.as_tensor(np.asarray(bird_img, np.float32)), self.device)
        msk = upload(torch.as_tensor(np.asarray(mask, np.float32)), self.device)
        if self.use_edge_filter:
            return edge_cloud_filtered(img, msk * 255.0, self.cfg)
        return edge_cloud(img, msk, self.cfg)

    def _set_key(self, cloud: EdgeCloud) -> None:
        self.key_cloud = cloud
        if self.method == "ndt":
            self.key_grid = build_ndt_grid(cloud)

    def add_new_frame(self, bird_img, mask) -> np.ndarray:
        cloud = self._cloud(bird_img, mask)
        if self.key_cloud is None:
            self._set_key(cloud)
            return self.pose.copy()
        # the registration starts from the current pose relative to the key
        rel0 = self.pose - self.key_pose
        c, s = np.cos(self.key_pose[2]), np.sin(self.key_pose[2])
        init = upload(torch.as_tensor(np.asarray([c * rel0[0] + s * rel0[1],
                                                  -s * rel0[0] + c * rel0[1],
                                                  rel0[2]], np.float32)), self.device)
        if self.method == "ndt":
            rel = ndt_se2(self.key_grid, cloud, init)
        else:
            rel = icp_se2(self.key_cloud, cloud, init)
        rel = rel.cpu().numpy()            # the frame's one host read
        # world pose = key_pose o rel
        self.pose = np.array([
            self.key_pose[0] + c * rel[0] - s * rel[1],
            self.key_pose[1] + s * rel[0] + c * rel[1],
            self.key_pose[2] + rel[2],
        ])
        # key-cloud update at 1 m / 5 deg (simple_birdseye_odometer.cpp:76-310)
        if np.hypot(rel[0], rel[1]) > 1.0 or abs(rel[2]) > np.deg2rad(5):
            self._set_key(cloud)
            self.key_pose = self.pose.copy()
        return self.pose.copy()
