"""Synthetic dual-view driving sequences with exact geometry — a copy of
``fishbirdeyevisualslam_tpu/io/synthetic.py`` for the port (numpy; the front
camera's mounting pose comes from the port's own geometry).

The reference's dataset (front fisheye + IPM birdview + masks + contour labels +
2D ground truth + wheel odometry, ``Examples/Monocular/mono_encoder.cc:220-252``)
is proprietary and not shipped, so the test/bench oracle is a renderer that
produces the same modalities from a procedurally textured world:

  * ground plane: smooth random texture (z = 0 in world frame),
  * vertical billboards: textured planes at random poses for mid-range front
    features,
  * bird view: exact IPM — top-down resampling of the ground texture around the
    vehicle (the real system's surround-view stitcher is upstream of the SLAM),
  * front view: fisheye raycast (equidistant model) onto ground + billboards,
  * contour labels: gradient-magnitude edges of the bird view (edge < 150
    convention of ``birdviewContourICP``),
  * odometry: ground truth SE2 + optional noise/drift.

Everything is numpy on the host (this is the dataset factory, not the compute
path).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import ipm as ipm_mod
from fishbirdeyevisualslam_torch.geometry import se3 as se3_mod


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


@dataclasses.dataclass
class SyntheticSequence:
    gt: np.ndarray
    odom: np.ndarray
    frames: list  # list of dicts: front, bird, mask, contour, timestamp

    def __len__(self):
        return len(self.frames)


# ---------------------------------------------------------------------------
# Sensor-realistic degradation (VERDICT round-2 missing #6: every accuracy
# number so far came from the CLEAN renderer; the reference's dataset is real
# camera imagery with exposure flicker, sensor noise, vignetting, motion blur,
# and IPM stitching artifacts).  The reference dataset itself is proprietary
# and this environment has no network egress, so the honest validation path is
# the same exact-geometry renderer pushed through a camera-degradation model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Camera/ISP degradation applied to the clean renders.

    Defaults model a mid-grade automotive sensor: +-25% exposure random walk
    frame to frame, sigma~6 gray-level read noise + shot noise, cos^4
    vignetting on the fisheye, 1-3 px motion blur along the travel direction,
    surround-view stitching seams + per-quadrant gain mismatch on the IPM
    image, and a 10% contour-label dropout (semantic segmentation misses)."""

    exposure_walk: float = 0.08   # std of per-frame log-gain random walk
    exposure_clip: float = 0.25   # max |log-gain|
    read_noise: float = 6.0       # gaussian sigma (gray levels)
    shot_noise: float = 0.35      # scale of sqrt(I) shot noise
    vignette: float = 0.35        # strength of cos^4 falloff at the corners
    motion_blur_px: float = 2.0   # blur length per unit step (px)
    bird_seam_gain: float = 0.12  # per-quadrant gain mismatch (surround stitch)
    bird_seam_px: int = 2         # bright seam width at quadrant boundaries
    contour_dropout: float = 0.10 # fraction of contour edge pixels dropped
    gamma_jitter: float = 0.06    # per-frame gamma wobble


def _directional_blur(img, dx, dy, length):
    """Cheap motion blur: average ``length`` shifted copies along (dx, dy)."""
    n = max(1, int(round(length)))
    if n <= 1:
        return img
    acc = np.zeros_like(img)
    for k in range(n):
        sx = int(round(dx * (k - (n - 1) / 2)))
        sy = int(round(dy * (k - (n - 1) / 2)))
        acc += np.roll(np.roll(img, sy, axis=0), sx, axis=1)
    return acc / n


_VIGNETTE_CACHE = {}


def degrade_front(img, cfg: SystemConfig, dg: DegradeConfig, rng, log_gain,
                  speed_px):
    cam = cfg.camera
    key = (cam.height, cam.width)
    if key not in _VIGNETTE_CACHE:
        vv, uu = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
        r2 = (((uu - cam.cx) / cam.fx) ** 2 + ((vv - cam.cy) / cam.fy) ** 2)
        _VIGNETTE_CACHE[key] = 1.0 / (1.0 + r2) ** 2  # cos^4
    vig = _VIGNETTE_CACHE[key]
    out = _directional_blur(img, 1.0, 0.15, speed_px)
    out = out * (1.0 - dg.vignette + dg.vignette * vig)
    gamma = 1.0 + rng.randn() * dg.gamma_jitter
    out = 255.0 * np.clip(out / 255.0, 0, 1) ** gamma
    out = out * np.exp(log_gain)
    out = out + rng.randn(*out.shape) * dg.read_noise \
        + rng.randn(*out.shape) * dg.shot_noise * np.sqrt(np.maximum(out, 0.0))
    return np.clip(out, 0.0, 255.0).astype(np.float32)


def degrade_bird(img, cfg: SystemConfig, dg: DegradeConfig, rng, log_gain):
    rows, cols = img.shape
    out = img.copy()
    cy, cx = rows // 2, cols // 2
    gains = np.exp(rng.randn(2, 2) * dg.bird_seam_gain)
    out[:cy, :cx] *= gains[0, 0]
    out[:cy, cx:] *= gains[0, 1]
    out[cy:, :cx] *= gains[1, 0]
    out[cy:, cx:] *= gains[1, 1]
    # bright seams where the four camera views meet (diagonals in real
    # surround stitches; axis-aligned here — what matters is that spurious
    # high-gradient structure crosses the whole image)
    s = dg.bird_seam_px
    if s > 0:
        out[cy - s:cy + s, :] = np.clip(out[cy - s:cy + s, :] * 1.3 + 20, 0, 255)
        out[:, cx - s:cx + s] = np.clip(out[:, cx - s:cx + s] * 1.3 + 20, 0, 255)
    out = out * np.exp(log_gain)
    out = out + rng.randn(rows, cols) * dg.read_noise
    return np.clip(out, 0.0, 255.0).astype(np.float32)


def degrade_contour(contour, dg: DegradeConfig, rng):
    """Semantic-contour imperfection: drop a fraction of edge pixels."""
    edge = contour < 150
    drop = rng.rand(*contour.shape) < dg.contour_dropout
    out = contour.copy()
    out[edge & drop] = 255.0
    return out


def render_frame(world: World, cfg: SystemConfig, pose_se2, i: int) -> dict:
    """Frame ``i`` of a sequence at ``pose_se2``, before any degradation: its
    images depend only on the world and the pose."""
    bird = render_bird(world, cfg, pose_se2)
    mask, contour = bird_mask_and_contour(cfg, bird)
    return dict(front=render_front(world, cfg, pose_se2), bird=bird, mask=mask, contour=contour,
                timestamp=i / cfg.camera.fps)


def make_sequence(cfg: SystemConfig, n_frames=40, kind="arc", odom_noise=0.0,
                  seed=0, step=0.35, degrade: "DegradeConfig | None" = None,
                  render=None) -> SyntheticSequence:
    """Render a sequence; pass ``degrade=DegradeConfig()`` for the
    sensor-degraded variant (contours are computed from the CLEAN bird image —
    the dataset's contour labels come from an upstream segmenter, not from the
    degraded pixels — then corrupted by label dropout).  ``render(world,
    gt)``, where given, returns the clean frames ``render_frame(world, cfg,
    gt[i], i)`` in order in place of the serial loop (a process pool's map,
    say); the degradation draws from its own generator frame by frame after
    them either way."""
    gt = make_trajectory(n_frames, kind, step=step, seed=seed)
    world = make_world(seed, traj=gt)
    odom = odometry_from_gt(gt, odom_noise, seed)
    frames = (render(world, gt) if render is not None
              else [render_frame(world, cfg, gt[i], i) for i in range(n_frames)])
    if degrade is not None:
        rng = np.random.RandomState(seed + 12345)
        log_gain = 0.0
        speed_px = degrade.motion_blur_px * step / 0.35
        for fr in frames:
            log_gain = float(np.clip(log_gain + rng.randn() * degrade.exposure_walk,
                                     -degrade.exposure_clip, degrade.exposure_clip))
            fr["front"] = degrade_front(fr["front"], cfg, degrade, rng, log_gain, speed_px)
            fr["bird"] = degrade_bird(fr["bird"], cfg, degrade, rng, log_gain)
            fr["contour"] = degrade_contour(fr["contour"], degrade, rng)
    return SyntheticSequence(gt=gt, odom=odom, frames=frames)
