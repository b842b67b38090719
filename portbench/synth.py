"""The drive's world, path and odometry, and the plain numpy renderer: a
frozen copy of ``fishbirdeyevisualslam_torch/io/synthetic.py`` (``make_world``
with its textures and markings, ``render_bird``, ``bird_mask_and_contour``,
``render_front``, ``make_trajectory``, ``odometry_from_gt``), unchanged but for
the camera's mounting pose, which comes from the benchmark's reference copy of
the port's geometry.

A procedurally textured world stands in for the upstream's proprietary
dataset (front fisheye + IPM bird view + freespace mask + 2D ground truth +
wheel odometry): the ground plane's value-noise texture with painted
markings, and textured vertical billboards along the path.  ``render.py``
renders the same world on the card; this numpy version is what a CPU test
holds it to.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from portbench.reference.geometry import ipm as ipm_mod
from portbench.reference.geometry import se3 as se3_mod


def _smooth_texture(rng, n, octaves=4, base=16):
    """Multi-octave value noise in [0, 255]."""
    tex = np.zeros((n, n), np.float32)
    for o in range(octaves):
        k = base * (2**o)
        if k > n:
            break
        coarse = rng.rand(k, k).astype(np.float32)
        reps = -(-n // k)  # ceil; crop back to n
        up = np.kron(coarse, np.ones((reps, reps), np.float32))[:n, :n]
        tex += up * (0.6**o)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    return (tex * 235.0 + 10.0).astype(np.float32)


def _bilinear(tex, y, x):
    h, w = tex.shape
    x0 = np.clip(np.floor(x).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int32), 0, h - 2)
    fx = np.clip(x - x0, 0, 1)
    fy = np.clip(y - y0, 0, 1)
    v00 = tex[y0, x0]
    v01 = tex[y0, x0 + 1]
    v10 = tex[y0 + 1, x0]
    v11 = tex[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


@dataclasses.dataclass
class Billboard:
    origin: np.ndarray   # (3,) world position of the lower-left corner
    u_dir: np.ndarray    # (3,) unit along width
    v_dir: np.ndarray    # (3,) unit along height (up)
    width: float
    height: float
    tex: np.ndarray      # (th, tw)


@dataclasses.dataclass
class World:
    ground: np.ndarray       # (N, N) texture
    ground_res: float        # meters per texel
    ground_origin: np.ndarray  # (2,) world xy of texel (0, 0)
    billboards: List[Billboard]

    def ground_at(self, x, y):
        tx = (x - self.ground_origin[0]) / self.ground_res
        ty = (y - self.ground_origin[1]) / self.ground_res
        return _bilinear(self.ground, ty, tx)


def _paint_markings(ground, rng, res, n_marks=160):
    """Paint bright/dark line segments onto the ground (lane-marking/curb
    analogs): real IPM imagery is contour-dominated, and these give the bird
    view distinctive, non-self-similar ORB descriptors (pure value-noise
    texture aliases badly)."""
    n = ground.shape[0]
    for _ in range(n_marks):
        x0, y0 = rng.randint(0, n, 2)
        ang = rng.uniform(0, np.pi)
        length = int(rng.uniform(0.5, 6.0) / res)
        width = max(1, int(rng.uniform(0.08, 0.3) / res))
        val = rng.choice([240.0, 15.0])
        dx, dy = np.cos(ang), np.sin(ang)
        ts = np.arange(length)
        xs = (x0 + ts * dx).astype(np.int32)
        ys = (y0 + ts * dy).astype(np.int32)
        for w in range(-(width // 2), width // 2 + 1):
            xw = np.clip(xs + int(round(w * -dy)), 0, n - 1)
            yw = np.clip(ys + int(round(w * dx)), 0, n - 1)
            ground[yw, xw] = val
    return ground


def make_world(seed=0, extent=120.0, res=0.04, n_billboards=24,
               traj=None) -> World:
    """``traj`` (N, 3) SE2 ground truth: when given, billboards are scattered
    ALONG the trajectory (random arc positions, 5-13 m lateral offset) so the
    whole path has mid-range front structure — a 175 m soak circle leaves the
    default origin-ring/corridor layout entirely and the front view degrades
    into a featureless void no real driving environment exhibits (soak r4
    root-caused its inlier collapse to exactly this)."""
    rng = np.random.RandomState(seed)
    n = int(extent / res)
    n = min(n, 4096)
    ground = _smooth_texture(rng, n)
    ground = _paint_markings(ground, rng, res)
    billboards = []
    if traj is not None:
        n_billboards = max(n_billboards, len(traj) // 8)
    for k in range(n_billboards):
        if traj is not None:
            # UNIFORM arc spacing + jitter: purely random placement leaves
            # multi-frame gaps with no front structure in view, and the
            # front inlier count craters through the tracking gate there
            i = (k * len(traj)) // n_billboards
            i = min(len(traj) - 1, i + rng.randint(0, max(1, len(traj) // (2 * n_billboards))))
            x0, y0, th0 = traj[i]
            side = rng.choice([-1, 1])
            off = rng.uniform(5, 13)
            x = x0 - side * np.sin(th0) * off
            y = y0 + side * np.cos(th0) * off
        elif k % 2 == 0:
            # boards flanking the road corridor (vehicle drives roughly along +x)
            x = rng.uniform(-10, 90)
            y = rng.choice([-1, 1]) * rng.uniform(4, 14)
        else:
            # boards ringing the start area so circular trajectories always have
            # mid-range front features in view
            ang = rng.uniform(0, 2 * np.pi)
            r = rng.uniform(14, 28)
            x = r * np.cos(ang)
            y = r * np.sin(ang)
        yaw = rng.uniform(0, 2 * np.pi)
        w = rng.uniform(3, 8)
        h = rng.uniform(2.5, 6)
        u = np.array([np.cos(yaw), np.sin(yaw), 0.0], np.float32)
        v = np.array([0.0, 0.0, 1.0], np.float32)
        billboards.append(Billboard(
            origin=np.array([x, y, 0.0], np.float32),
            u_dir=u, v_dir=v, width=w, height=h,
            tex=_smooth_texture(rng, 256, octaves=5, base=8),
        ))
    return World(
        ground=ground, ground_res=res,
        ground_origin=np.array([-extent * 0.25, -extent * 0.5], np.float32),
        billboards=billboards,
    )


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _se2_mat(pose):
    x, y, th = pose
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, x], [s, c, y], [0, 0, 1]], np.float32)


def render_bird(world: World, cfg: SystemConfig, pose_se2) -> np.ndarray:
    """Exact IPM: sample the ground texture on the bird-view pixel grid
    (``Converter::BirdPixel2BaseXY`` geometry)."""
    b = cfg.bird
    rows, cols = b.rows, b.cols
    vv, uu = np.mgrid[0:rows, 0:cols].astype(np.float32)
    bx = (rows / 2.0 - vv) * b.pixel2meter + b.rear_axle_to_center
    by = (cols / 2.0 - uu) * b.pixel2meter
    M = _se2_mat(pose_se2)
    wx = M[0, 0] * bx + M[0, 1] * by + M[0, 2]
    wy = M[1, 0] * bx + M[1, 1] * by + M[1, 2]
    return world.ground_at(wx, wy).astype(np.float32)


def bird_mask_and_contour(cfg: SystemConfig, bird_img) -> Tuple[np.ndarray, np.ndarray]:
    """Freespace mask (vehicle footprint blanked, like ``mono_encoder.cc:279-313``)
    and a contour-label image: edge pixels < 150 (gradient-magnitude threshold
    standing in for the dataset's precomputed semantic contours)."""
    b = cfg.bird
    rows, cols = bird_img.shape
    mask = np.ones((rows, cols), bool)
    # vehicle footprint rectangle around image center
    half_l = 0.5 * b.vehicle_length * b.meter2pixel
    half_w = 0.5 * b.vehicle_width * b.meter2pixel
    cy, cx = rows / 2.0, cols / 2.0
    y0, y1 = int(cy - half_l), int(cy + half_l)
    x0, x1 = int(cx - half_w), int(cx + half_w)
    mask[max(0, y0):y1, max(0, x0):x1] = False
    gy, gx = np.gradient(bird_img)
    gmag = np.hypot(gx, gy)
    contour = np.where(gmag > np.percentile(gmag, 70), 0.0, 255.0).astype(np.float32)
    return mask, contour


def _fisheye_rays(cfg: SystemConfig):
    """Per-pixel unit ray directions in the camera frame (equidistant model)."""
    cam = cfg.camera
    h, w = cam.height, cam.width
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    xd = (uu - cam.cx) / cam.fx
    yd = (vv - cam.cy) / cam.fy
    theta_d = np.hypot(xd, yd)
    # invert the distortion polynomial by Newton (vectorized, 8 iters)
    theta = theta_d.copy()
    for _ in range(8):
        t2 = theta * theta
        f = theta * (1 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * cam.k4)))) - theta_d
        fp = 1 + t2 * (3 * cam.k1 + t2 * (5 * cam.k2 + t2 * (7 * cam.k3 + t2 * 9 * cam.k4)))
        theta = theta - f / np.maximum(fp, 1e-6)
    theta = np.clip(theta, 0, 1.55)
    phi = np.arctan2(yd, xd)
    sin_t = np.sin(theta)
    d = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), np.cos(theta)], axis=-1)
    return d.reshape(-1, 3)  # (h*w, 3)


_RAY_CACHE = {}


def render_front(world: World, cfg: SystemConfig, pose_se2) -> np.ndarray:
    """Fisheye raycast of ground + billboards from the front camera pose."""
    cam = cfg.camera
    key = (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    if key not in _RAY_CACHE:
        _RAY_CACHE[key] = _fisheye_rays(cfg)
    rays_c = _RAY_CACHE[key]

    # camera pose in world: Twc = Twb * Tbc
    Twb = np.eye(4, dtype=np.float32)
    M = _se2_mat(pose_se2)
    Twb[:2, :2] = M[:2, :2]
    Twb[:2, 3] = M[:2, 2]
    T = ipm_mod.extrinsics_Tbc(cfg.extrinsics)
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, :3] = se3_mod.quat_to_matrix(T[:4]).numpy()
    Tbc[:3, 3] = T[4:].numpy()
    Twc = Twb @ Tbc
    R, t = Twc[:3, :3], Twc[:3, 3]
    rays_w = rays_c @ R.T            # (N, 3)
    o = t[None, :]

    n_px = rays_w.shape[0]
    best_t = np.full(n_px, np.inf, np.float32)
    color = np.full(n_px, 96.0, np.float32)  # sky

    # ground plane z=0
    dz = rays_w[:, 2]
    tg = np.where(dz < -1e-6, -o[:, 2] / np.where(np.abs(dz) < 1e-6, -1e-6, dz), np.inf)
    hit = (tg > 0.1) & (tg < 400.0)
    gx = o[:, 0] + tg * rays_w[:, 0]
    gy = o[:, 1] + tg * rays_w[:, 1]
    val = world.ground_at(np.where(hit, gx, 0.0), np.where(hit, gy, 0.0))
    upd = hit & (tg < best_t)
    best_t = np.where(upd, tg, best_t)
    color = np.where(upd, val, color)

    # billboards (distance-culled: boards beyond 80 m subtend < a pixel at
    # this focal length; trajectory-scattered worlds carry ~90 boards and the
    # raycast loop dominates render time without the cull)
    for bb in world.billboards:
        if np.hypot(bb.origin[0] - t[0], bb.origin[1] - t[1]) > 80.0:
            continue
        nrm = np.cross(bb.u_dir, bb.v_dir)
        denom = rays_w @ nrm
        tb = ((bb.origin - t) @ nrm) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
        p = o + tb[:, None] * rays_w
        lu = (p - bb.origin) @ bb.u_dir
        lv = (p - bb.origin) @ bb.v_dir
        hit = (tb > 0.1) & (tb < best_t) & (lu >= 0) & (lu <= bb.width) & (lv >= 0) & (lv <= bb.height)
        idx = np.nonzero(hit)[0]   # a board covers a few pixels: sample its texture there only
        th, tw = bb.tex.shape
        color[idx] = _bilinear(bb.tex, np.clip(lv[idx] / bb.height, 0, 1) * (th - 2),
                               np.clip(lu[idx] / bb.width, 0, 1) * (tw - 2))
        best_t[idx] = tb[idx]

    return color.reshape(cam.height, cam.width)


# ---------------------------------------------------------------------------
# Sequences
# ---------------------------------------------------------------------------


def make_trajectory(n_frames=60, kind="arc", step=0.35, seed=0):
    """SE2 ground-truth poses: gentle arc / straight / s-curve."""
    rng = np.random.RandomState(seed)
    poses = []
    x = y = th = 0.0
    for i in range(n_frames):
        if kind == "arc":
            dth = 0.008
        elif kind == "s":
            dth = 0.012 * np.sin(i / 12.0)
        elif kind == "circle":
            dth = 2 * np.pi / n_frames  # closes a full loop
        elif kind == "rect":
            # rounded rectangle returning to the start: 4 straights + 4 quarter
            # arcs (the loop-closure stress case — the far side leaves the
            # start's covisibility entirely, unlike "circle")
            n_corner = max(4, n_frames // 16)
            n_straight = max(1, n_frames // 4 - n_corner)
            phase = i % (n_straight + n_corner)
            dth = (np.pi / 2) / n_corner if phase >= n_straight else 0.0
        else:
            dth = 0.0
        th += dth
        x += step * np.cos(th)
        y += step * np.sin(th)
        poses.append([x, y, th])
    return np.asarray(poses, np.float32)


def odometry_from_gt(gt, noise=0.0, seed=0):
    """Wheel odometry readings: GT + optional per-step gaussian drift."""
    if noise <= 0:
        return gt.copy()
    rng = np.random.RandomState(seed)
    odom = gt.copy()
    drift = np.cumsum(rng.randn(len(gt), 3) * noise, axis=0)
    drift[:, 2] *= 0.1
    return (odom + drift).astype(np.float32)


