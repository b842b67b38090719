"""Model-breaking world realism for the synthetic oracle: a copy of
``fishbirdeyevisualslam_tpu/io/realism.py`` for the port (numpy; the quaternion
product and the camera's mounting pose come from the port's own geometry;
``make_real_sequence`` takes a renderer for its clean frames, as
``synthetic.make_sequence`` does).

``io.synthetic`` renders a world that satisfies the SLAM's assumed models
EXACTLY (flat ground at z=0, perfect IPM constants, perfect extrinsics) — so
every accuracy number is the geometry engine grading itself.  Real data breaks
those assumptions.  This module renders sequences where the WORLD violates the
models the estimator assumes, while ground truth stays exact:

  * **ground relief** — a smooth ±few-cm height field.  The surround-view
    stitcher projects onto an assumed z=0 plane, so true relief displaces IPM
    texture radially by ``z * r / h_cam`` (growing with distance, exactly the
    swim real IPM imagery shows); the front raycast hits the true surface.
  * **extrinsic miscalibration** — the renderer uses camera-to-base extrinsics
    perturbed by ~0.3 deg / 2 cm from what the SLAM's config assumes, plus an
    IPM scale error (pixel2meter off by ~0.5%): systematic, not noise.
  * **3D clutter boxes** (parked-car analogs) — occlude the front view AND
    leak into the bird view at their true height: their texture back-projects
    to the WRONG ground position (the classic bird-view outlier source the
    reference gates with FilterBirdOutlier, ``Tracking.cc:1684-1823``).
  * **photoreal-statistics textures** — asphalt granularity + cracks + worn
    dashed lane markings + facade-like billboards, replacing value noise whose
    self-similarity inflates descriptor distinctiveness.

Composable with ``synthetic.DegradeConfig`` (sensor/ISP degradation) for the
full gauntlet: model violations + sensor corruption.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import ipm as ipm_mod
from fishbirdeyevisualslam_torch.geometry import se3 as se3_mod
from fishbirdeyevisualslam_torch.io import synthetic as syn


@dataclasses.dataclass(frozen=True)
class RealismConfig:
    """Degrees of model violation.  Defaults model a decent parking lot:
    centimeter relief, factory-calibration error, a handful of parked cars."""

    relief_amp_m: float = 0.03        # ground height field amplitude (std)
    relief_wavelength_m: float = 3.0  # smoothness of the height field
    cam_height_m: float = 1.2         # assumed surround-camera height (IPM swim)
    extrinsic_rot_deg: float = 0.3    # renderer-vs-config mount rotation error
    extrinsic_trans_m: float = 0.02   # renderer-vs-config mount offset
    ipm_scale_err: float = 0.005      # true pixel2meter = cfg's * (1 + this)
    n_clutter: int = 10               # parked-car-analog boxes
    clutter_height_m: float = 1.5


# ---------------------------------------------------------------------------
# Photoreal-statistics textures
# ---------------------------------------------------------------------------


def asphalt_texture(rng, n, res):
    """Asphalt: fine granularity + sparse dark cracks + repair patches."""
    # fine grain: white noise low-pass filtered once (keeps high frequency)
    g = rng.randn(n, n).astype(np.float32)
    g = (g + np.roll(g, 1, 0) + np.roll(g, 1, 1) + np.roll(g, (1, 1), (0, 1))) / 4
    tex = 110.0 + 14.0 * g
    # large-scale albedo drift (wet patches, wear)
    coarse = syn._smooth_texture(rng, n, octaves=3, base=8)
    tex = tex + 0.25 * (coarse - coarse.mean())
    # cracks: dark random walks
    for _ in range(max(4, n // 256)):
        x, y = rng.randint(0, n, 2)
        ang = rng.uniform(0, 2 * np.pi)
        for _ in range(int(rng.uniform(1.0, 8.0) / res)):
            ang += rng.randn() * 0.25
            x = int(np.clip(x + np.cos(ang), 0, n - 1))
            y = int(np.clip(y + np.sin(ang), 0, n - 1))
            tex[y, x] = 35.0
            if rng.rand() < 0.3:
                tex[min(y + 1, n - 1), x] = 45.0
    # repair patches: darker rectangles with soft edges
    for _ in range(max(2, n // 512)):
        w = int(rng.uniform(1.0, 4.0) / res)
        h = int(rng.uniform(1.0, 4.0) / res)
        x0 = rng.randint(0, max(1, n - w))
        y0 = rng.randint(0, max(1, n - h))
        tex[y0:y0 + h, x0:x0 + w] = tex[y0:y0 + h, x0:x0 + w] * 0.75
    return np.clip(tex, 0, 255)


def paint_worn_markings(tex, rng, res):
    """Dashed lane lines + arrows with per-texel wear (broken bright paint)."""
    n = tex.shape[0]
    for _ in range(8):
        x0, y0 = rng.randint(0, n, 2)
        ang = rng.uniform(0, np.pi)
        dash = int(1.5 / res)
        gap = int(1.0 / res)
        width = max(2, int(0.12 / res))
        total = int(rng.uniform(10, 40) / res)
        dx, dy = np.cos(ang), np.sin(ang)
        for s in range(0, total, dash + gap):
            ts = np.arange(min(dash, total - s))
            xs = (x0 + (s + ts) * dx).astype(np.int32)
            ys = (y0 + (s + ts) * dy).astype(np.int32)
            for w in range(-(width // 2), width // 2 + 1):
                xw = np.clip(xs + int(round(w * -dy)), 0, n - 1)
                yw = np.clip(ys + int(round(w * dx)), 0, n - 1)
                wear = rng.rand(len(xw)) > 0.15      # 15% of paint chipped off
                tex[yw[wear], xw[wear]] = 225.0 + 20.0 * rng.randn()
    return tex


def facade_texture(rng, n=256):
    """Building-facade billboard: window grid over a brick-toned wall."""
    tex = np.full((n, n), 120.0, np.float32) + rng.randn(n, n) * 6
    # brick courses
    course = max(4, n // 32)
    tex[::course, :] *= 0.85
    # window grid
    nw = rng.randint(3, 6)
    nh = rng.randint(3, 6)
    for i in range(nw):
        for j in range(nh):
            x0 = int((i + 0.25) * n / nw)
            x1 = int((i + 0.75) * n / nw)
            y0 = int((j + 0.25) * n / nh)
            y1 = int((j + 0.75) * n / nh)
            tex[y0:y1, x0:x1] = 40.0 + rng.rand() * 50.0  # glass
            tex[y0:y0 + 2, x0:x1] = 200.0                 # sill highlight
    return tex


# ---------------------------------------------------------------------------
# Model-violating world
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Clutter:
    center: np.ndarray  # (2,) world xy
    half: np.ndarray    # (2,) half extents xy
    height: float
    tex: np.ndarray     # side/top texture


@dataclasses.dataclass
class RealWorld:
    base: syn.World
    relief: np.ndarray          # (R, R) height field (meters)
    relief_res: float
    relief_origin: np.ndarray
    clutter: List[Clutter]
    rc: RealismConfig

    def height_at(self, x, y):
        tx = (x - self.relief_origin[0]) / self.relief_res
        ty = (y - self.relief_origin[1]) / self.relief_res
        return syn._bilinear(self.relief, ty, tx)


def make_real_world(cfg: SystemConfig, rc: RealismConfig = RealismConfig(),
                    seed=0, extent=120.0, res=0.04, traj=None) -> RealWorld:
    rng = np.random.RandomState(seed)
    n = min(int(extent / res), 4096)
    ground = asphalt_texture(rng, n, res)
    ground = paint_worn_markings(ground, rng, res)
    billboards = []
    n_bb = 16 if traj is None else max(16, len(traj) // 8)
    for k in range(n_bb):
        if traj is not None:
            # facades along the path, uniformly arc-spaced with jitter (see
            # synthetic.make_world: random placement leaves structure gaps)
            i = (k * len(traj)) // n_bb
            i = min(len(traj) - 1,
                    i + rng.randint(0, max(1, len(traj) // (2 * n_bb))))
            x0, y0, th0 = traj[i]
            side = rng.choice([-1, 1])
            off = rng.uniform(5, 13)
            x = x0 - side * np.sin(th0) * off
            y = y0 + side * np.cos(th0) * off
        elif k % 2 == 0:
            x = rng.uniform(-10, 90)
            y = rng.choice([-1, 1]) * rng.uniform(4, 14)
        else:
            ang = rng.uniform(0, 2 * np.pi)
            r = rng.uniform(14, 28)
            x, y = r * np.cos(ang), r * np.sin(ang)
        yaw = rng.uniform(0, 2 * np.pi)
        u = np.array([np.cos(yaw), np.sin(yaw), 0.0], np.float32)
        billboards.append(syn.Billboard(
            origin=np.array([x, y, 0.0], np.float32),
            u_dir=u, v_dir=np.array([0.0, 0.0, 1.0], np.float32),
            width=rng.uniform(4, 10), height=rng.uniform(3, 7),
            tex=facade_texture(rng),
        ))
    base = syn.World(
        ground=ground, ground_res=res,
        ground_origin=np.array([-extent * 0.25, -extent * 0.5], np.float32),
        billboards=billboards,
    )
    # smooth height field
    rr = 0.5  # relief grid resolution (m)
    rn = int(extent / rr)
    k = max(2, int(rn * rr / rc.relief_wavelength_m))
    coarse = rng.randn(k, k).astype(np.float32)
    reps = -(-rn // k)
    relief = np.kron(coarse, np.ones((reps, reps), np.float32))[:rn, :rn]
    # two smoothing passes
    for _ in range(2):
        relief = (relief + np.roll(relief, 1, 0) + np.roll(relief, -1, 0)
                  + np.roll(relief, 1, 1) + np.roll(relief, -1, 1)) / 5
    relief = relief / (relief.std() + 1e-9) * rc.relief_amp_m
    clutter = []
    for _ in range(rc.n_clutter):
        ang = rng.uniform(0, 2 * np.pi)
        r = rng.uniform(6, 20)
        clutter.append(Clutter(
            center=np.array([r * np.cos(ang), r * np.sin(ang)], np.float32),
            half=np.array([rng.uniform(0.8, 2.2), rng.uniform(0.7, 1.0)], np.float32),
            height=rc.clutter_height_m * rng.uniform(0.7, 1.2),
            tex=syn._smooth_texture(rng, 128, octaves=4, base=4),
        ))
    return RealWorld(base=base, relief=relief, relief_res=rr,
                     relief_origin=np.array([-extent * 0.25, -extent * 0.5],
                                            np.float32),
                     clutter=clutter, rc=rc)


def _perturbed_cfg(cfg: SystemConfig, rc: RealismConfig, seed) -> SystemConfig:
    """The TRUE world constants the renderer uses (the SLAM keeps ``cfg``)."""
    rng = np.random.RandomState(seed + 777)
    ex = cfg.extrinsics
    # perturb the camera-to-base quaternion by a small random rotation
    ax = rng.randn(3)
    ax /= np.linalg.norm(ax)
    th = np.deg2rad(rc.extrinsic_rot_deg)
    dq = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * ax]).astype(np.float32)
    x, y, z, w = ex.q_bc_xyzw
    q = np.asarray([w, x, y, z], np.float32)  # wxyz for quat_mul
    q_new = se3_mod.quat_mul(torch.from_numpy(q), torch.from_numpy(dq)).numpy()
    t_new = np.asarray(ex.t_bc, np.float32) + rng.randn(3).astype(np.float32) * rc.extrinsic_trans_m
    ex2 = dataclasses.replace(
        ex,
        q_bc_xyzw=(float(q_new[1]), float(q_new[2]), float(q_new[3]),
                   float(q_new[0])),
        t_bc=tuple(float(v) for v in t_new))
    bird2 = dataclasses.replace(
        cfg.bird, pixel2meter=cfg.bird.pixel2meter * (1.0 + rc.ipm_scale_err))
    return cfg.replace(extrinsics=ex2, bird=bird2)


def render_bird_real(world: RealWorld, cfg_true: SystemConfig, pose_se2):
    """IPM resampling with relief-induced radial swim + clutter leakage."""
    b = cfg_true.bird
    rows, cols = b.rows, b.cols
    vv, uu = np.mgrid[0:rows, 0:cols].astype(np.float32)
    bx = (rows / 2.0 - vv) * b.pixel2meter + b.rear_axle_to_center
    by = (cols / 2.0 - uu) * b.pixel2meter
    M = syn._se2_mat(pose_se2)
    wx = M[0, 0] * bx + M[0, 1] * by + M[0, 2]
    wy = M[1, 0] * bx + M[1, 1] * by + M[1, 2]
    # relief swim: the stitcher assumed z=0; true height z displaces the
    # sampled texture RADIALLY (from vehicle center) by z * r / h_cam
    z = world.height_at(wx, wy)
    scale = 1.0 + z / world.rc.cam_height_m
    bx_s = bx * scale
    by_s = by * scale
    wx_s = M[0, 0] * bx_s + M[0, 1] * by_s + M[0, 2]
    wy_s = M[1, 0] * bx_s + M[1, 1] * by_s + M[1, 2]
    img = world.base.ground_at(wx_s, wy_s).astype(np.float32)
    # clutter leakage: box tops render at displaced (elevated) positions
    for c in world.clutter:
        sc = 1.0 + c.height / world.rc.cam_height_m
        # a bird pixel shows the box top if its scaled ground point lies on it
        lx = wx_s - c.center[0]
        ly = wy_s - c.center[1]
        on = (np.abs(lx) < c.half[0] * sc) & (np.abs(ly) < c.half[1] * sc)
        if on.any():
            th, tw = c.tex.shape
            tx = (lx / (2 * c.half[0] * sc) + 0.5) * (tw - 2)
            ty = (ly / (2 * c.half[1] * sc) + 0.5) * (th - 2)
            img = np.where(on, syn._bilinear(c.tex, ty, tx), img)
    return img


def render_front_real(world: RealWorld, cfg_true: SystemConfig, pose_se2):
    """Fisheye raycast against relief ground + billboards + clutter boxes."""
    cam = cfg_true.camera
    key = ("real", cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    if key not in syn._RAY_CACHE:
        syn._RAY_CACHE[key] = syn._fisheye_rays(cfg_true)
    rays_c = syn._RAY_CACHE[key]
    Twb = np.eye(4, dtype=np.float32)
    M = syn._se2_mat(pose_se2)
    Twb[:2, :2] = M[:2, :2]
    Twb[:2, 3] = M[:2, 2]
    T = ipm_mod.extrinsics_Tbc(cfg_true.extrinsics)
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, :3] = se3_mod.quat_to_matrix(T[:4]).numpy()
    Tbc[:3, 3] = T[4:].numpy()
    Twc = Twb @ Tbc
    R, t = Twc[:3, :3], Twc[:3, 3]
    rays_w = rays_c @ R.T
    o = t[None, :]

    n_px = rays_w.shape[0]
    best_t = np.full(n_px, np.inf, np.float32)
    color = np.full(n_px, 96.0, np.float32)

    # ground: flat intersect, one relief correction step
    dz = rays_w[:, 2]
    tg = np.where(dz < -1e-6, -o[:, 2] / np.where(np.abs(dz) < 1e-6, -1e-6, dz), np.inf)
    gx = o[:, 0] + tg * rays_w[:, 0]
    gy = o[:, 1] + tg * rays_w[:, 1]
    zg = world.height_at(np.where(np.isfinite(tg), gx, 0.0),
                         np.where(np.isfinite(tg), gy, 0.0))
    tg2 = np.where(np.isfinite(tg),
                   tg * (o[:, 2] - zg) / np.maximum(o[:, 2], 1e-3), tg)
    hit = np.isfinite(tg2) & (tg2 > 0.1) & (tg2 < 400.0)
    gx = o[:, 0] + tg2 * rays_w[:, 0]
    gy = o[:, 1] + tg2 * rays_w[:, 1]
    val = world.base.ground_at(np.where(hit, gx, 0.0), np.where(hit, gy, 0.0))
    upd = hit & (tg2 < best_t)
    best_t = np.where(upd, tg2, best_t)
    color = np.where(upd, val, color)

    # billboards (distance-culled like synthetic.render_front)
    for bb in world.base.billboards:
        if np.hypot(bb.origin[0] - t[0], bb.origin[1] - t[1]) > 80.0:
            continue
        nrm = np.cross(bb.u_dir, bb.v_dir)
        denom = rays_w @ nrm
        tb = ((bb.origin - t) @ nrm) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
        p = o + tb[:, None] * rays_w
        lu = (p - bb.origin) @ bb.u_dir
        lv = (p - bb.origin) @ bb.v_dir
        hitb = (tb > 0.1) & (tb < best_t) & (lu >= 0) & (lu <= bb.width) \
            & (lv >= 0) & (lv <= bb.height)
        th, tw = bb.tex.shape
        val = syn._bilinear(bb.tex, np.clip(lv / bb.height, 0, 1) * (th - 2),
                            np.clip(lu / bb.width, 0, 1) * (tw - 2))
        best_t = np.where(hitb, tb, best_t)
        color = np.where(hitb, val, color)

    # clutter boxes: 4 side faces + top
    for c in world.clutter:
        faces = []
        cx, cy = c.center
        hx, hy = c.half
        faces.append((np.array([cx - hx, cy - hy, 0.0]), np.array([1.0, 0, 0]),
                      np.array([0.0, 0, 1]), 2 * hx, c.height))     # -y face
        faces.append((np.array([cx - hx, cy + hy, 0.0]), np.array([1.0, 0, 0]),
                      np.array([0.0, 0, 1]), 2 * hx, c.height))     # +y face
        faces.append((np.array([cx - hx, cy - hy, 0.0]), np.array([0.0, 1, 0]),
                      np.array([0.0, 0, 1]), 2 * hy, c.height))     # -x face
        faces.append((np.array([cx + hx, cy - hy, 0.0]), np.array([0.0, 1, 0]),
                      np.array([0.0, 0, 1]), 2 * hy, c.height))     # +x face
        faces.append((np.array([cx - hx, cy - hy, c.height]), np.array([1.0, 0, 0]),
                      np.array([0.0, 1, 0]), 2 * hx, 2 * hy))       # top
        th_, tw_ = c.tex.shape
        for origin, u_dir, v_dir, w_ext, h_ext in faces:
            nrm = np.cross(u_dir, v_dir).astype(np.float32)
            denom = rays_w @ nrm
            tb = ((origin - t) @ nrm) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            p = o + tb[:, None] * rays_w
            lu = (p - origin) @ u_dir
            lv = (p - origin) @ v_dir
            hitc = (tb > 0.1) & (tb < best_t) & (lu >= 0) & (lu <= w_ext) \
                & (lv >= 0) & (lv <= h_ext)
            val = syn._bilinear(c.tex, np.clip(lv / h_ext, 0, 1) * (th_ - 2),
                                np.clip(lu / w_ext, 0, 1) * (tw_ - 2))
            best_t = np.where(hitc, tb, best_t)
            color = np.where(hitc, val, color)

    return color.reshape(cam.height, cam.width)


def render_real_frame(world: RealWorld, cfg: SystemConfig, cfg_true: SystemConfig, pose_se2,
                      i: int) -> dict:
    """Frame ``i`` of a model-violating sequence at ``pose_se2``, before any
    degradation: rendered with the true constants ``cfg_true``, its
    freespace mask and contour labelled under the SLAM's ``cfg``."""
    bird = np.clip(render_bird_real(world, cfg_true, pose_se2), 0.0, 255.0)
    mask, contour = syn.bird_mask_and_contour(cfg, bird)
    front = np.clip(render_front_real(world, cfg_true, pose_se2), 0.0, 255.0)
    return dict(front=front, bird=bird, mask=mask, contour=contour,
                timestamp=i / cfg.camera.fps)


def make_real_sequence(cfg: SystemConfig, n_frames=40, kind="arc",
                       odom_noise=0.0, seed=0, step=0.35,
                       rc: RealismConfig = RealismConfig(),
                       degrade: "syn.DegradeConfig | None" = None,
                       render=None) -> syn.SyntheticSequence:
    """Model-violating sequence: rendered with perturbed true constants and a
    non-flat, cluttered world; the SLAM consumes it under its UNPERTURBED
    config.  Optionally stacked with sensor degradation.  ``render(world,
    cfg_true, gt)``, where given, returns the clean frames
    ``render_real_frame(world, cfg, cfg_true, gt[i], i)`` in order in place
    of the serial loop (a process pool's map, say); the degradation draws
    from its own generator frame by frame after them either way."""
    gt = syn.make_trajectory(n_frames, kind, step=step, seed=seed)
    world = make_real_world(cfg, rc, seed, traj=gt)
    cfg_true = _perturbed_cfg(cfg, rc, seed)
    odom = syn.odometry_from_gt(gt, odom_noise, seed)
    frames = (render(world, cfg_true, gt) if render is not None
              else [render_real_frame(world, cfg, cfg_true, gt[i], i) for i in range(n_frames)])
    if degrade is not None:
        rng = np.random.RandomState(seed + 12345)
        log_gain = 0.0
        speed_px = degrade.motion_blur_px * step / 0.35
        for fr in frames:
            log_gain = float(np.clip(
                log_gain + rng.randn() * degrade.exposure_walk,
                -degrade.exposure_clip, degrade.exposure_clip))
            fr["front"] = syn.degrade_front(fr["front"], cfg, degrade, rng, log_gain, speed_px)
            fr["bird"] = syn.degrade_bird(fr["bird"], cfg, degrade, rng, log_gain)
            fr["contour"] = syn.degrade_contour(fr["contour"], degrade, rng)
    return syn.SyntheticSequence(gt=gt, odom=odom, frames=frames)
