"""The drive's frames rendered in PyTorch on the card: ``synth.py``'s
``render_bird`` and ``render_front`` over a batch of poses, the same
arithmetic in float32, so that a run's set-up renders its whole drive in a
few seconds where the numpy renderer takes most of a second a frame.

The world (textures, markings, billboards) is built by ``synth.make_world``
on the host from the seed and copied to the card once; the fisheye rays are
``synth._fisheye_rays``.  Frames come back to host memory as uint8, as a
camera delivers them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import synth

CHUNK = 8  # frames rendered together: (CHUNK, H*W) f32 temporaries


class DeviceWorld:
    """A ``synth.World`` on ``device``."""

    def __init__(self, world: synth.World, device):
        self.device = device
        dev = device
        self.ground = torch.as_tensor(world.ground, device=dev)
        self.res = world.ground_res
        self.origin = torch.as_tensor(world.ground_origin, device=dev)
        bbs = world.billboards
        self.bb_origin = torch.as_tensor(np.stack([b.origin for b in bbs]), device=dev)
        self.bb_u = torch.as_tensor(np.stack([b.u_dir for b in bbs]), device=dev)
        self.bb_v = torch.as_tensor(np.stack([b.v_dir for b in bbs]), device=dev)
        self.bb_n = torch.as_tensor(np.stack([np.cross(b.u_dir, b.v_dir) for b in bbs]),
                                    device=dev)
        self.bb_w = [float(b.width) for b in bbs]
        self.bb_h = [float(b.height) for b in bbs]
        self.bb_tex = [torch.as_tensor(b.tex, device=dev) for b in bbs]
        self.bb_xy = np.stack([b.origin[:2] for b in bbs])

    def ground_at(self, x, y):
        return bilinear(self.ground, (y - self.origin[1]) / self.res,
                        (x - self.origin[0]) / self.res)


def bilinear(tex, y, x):
    """``synth._bilinear`` on tensors."""
    h, w = tex.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0, 0, 1)
    fy = torch.clamp(y - y0, 0, 1)
    flat = tex.reshape(-1)
    i00 = y0 * w + x0
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + w], flat[i00 + w + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _se2(poses):
    """(N, 3) SE2 poses -> cos, sin, x, y columns, each (N, 1)."""
    x, y, th = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    return torch.cos(th), torch.sin(th), x, y


def render_bird(dw: DeviceWorld, cfg, poses) -> torch.Tensor:
    """(N, 3) poses -> (N, rows, cols) f32 bird views (``synth.render_bird``)."""
    b = cfg.bird
    rows, cols = b.rows, b.cols
    vv, uu = torch.meshgrid(torch.arange(rows, dtype=torch.float32, device=dw.device),
                            torch.arange(cols, dtype=torch.float32, device=dw.device),
                            indexing="ij")
    bx = ((rows / 2.0 - vv) * b.pixel2meter + b.rear_axle_to_center).reshape(1, -1)
    by = ((cols / 2.0 - uu) * b.pixel2meter).reshape(1, -1)
    c, s, x, y = _se2(poses)
    wx = c * bx + (-s) * by + x
    wy = s * bx + c * by + y
    return dw.ground_at(wx, wy).reshape(-1, rows, cols)


def _Tbc(cfg) -> np.ndarray:
    from portbench.reference.geometry import ipm, se3
    T = ipm.extrinsics_Tbc(cfg.extrinsics)
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, :3] = se3.quat_to_matrix(T[:4]).numpy()
    Tbc[:3, 3] = T[4:].numpy()
    return Tbc


def render_front(dw: DeviceWorld, cfg, poses_np: np.ndarray, rays_c) -> torch.Tensor:
    """(N, 3) poses -> (N, H, W) f32 fisheye views (``synth.render_front``)."""
    cam = cfg.camera
    dev = dw.device
    n = poses_np.shape[0]
    Tbc = _Tbc(cfg)
    Twc = np.empty((n, 4, 4), np.float32)
    for i, p in enumerate(poses_np):
        Twb = np.eye(4, dtype=np.float32)
        M = synth._se2_mat(p)
        Twb[:2, :2] = M[:2, :2]
        Twb[:2, 3] = M[:2, 2]
        Twc[i] = Twb @ Tbc
    R = torch.as_tensor(Twc[:, :3, :3], device=dev)
    t = torch.as_tensor(Twc[:, :3, 3], device=dev)
    rays_w = torch.einsum("pk,njk->npj", rays_c, R)   # rays_c @ R.T per frame
    o = t[:, None, :]
    n_px = rays_w.shape[1]
    best_t = torch.full((n, n_px), float("inf"), device=dev)
    color = torch.full((n, n_px), 96.0, device=dev)

    dz = rays_w[..., 2]
    tg = torch.where(dz < -1e-6, -o[..., 2] / torch.where(torch.abs(dz) < 1e-6, -1e-6, dz),
                     float("inf"))
    hit = (tg > 0.1) & (tg < 400.0)
    gx = o[..., 0] + tg * rays_w[..., 0]
    gy = o[..., 1] + tg * rays_w[..., 1]
    val = dw.ground_at(torch.where(hit, gx, 0.0), torch.where(hit, gy, 0.0))
    upd = hit & (tg < best_t)
    best_t = torch.where(upd, tg, best_t)
    color = torch.where(upd, val, color)

    t_np = Twc[:, :3, 3]
    for k in range(len(dw.bb_tex)):
        near = np.hypot(dw.bb_xy[k, 0] - t_np[:, 0], dw.bb_xy[k, 1] - t_np[:, 1]) <= 80.0
        if not near.any():
            continue
        org, u, v, nrm = dw.bb_origin[k], dw.bb_u[k], dw.bb_v[k], dw.bb_n[k]
        denom = rays_w @ nrm
        tb = (((org - t) @ nrm)[:, None]
              / torch.where(torch.abs(denom) < 1e-6, 1e-6, denom))
        p = o + tb[..., None] * rays_w
        lu = (p - org) @ u
        lv = (p - org) @ v
        w, h = dw.bb_w[k], dw.bb_h[k]
        hit = ((tb > 0.1) & (tb < best_t) & (lu >= 0) & (lu <= w) & (lv >= 0) & (lv <= h)
               & torch.as_tensor(near, device=dev)[:, None])
        tex = dw.bb_tex[k]
        th_, tw_ = tex.shape
        val = bilinear(tex, torch.clamp(lv / h, 0, 1) * (th_ - 2),
                       torch.clamp(lu / w, 0, 1) * (tw_ - 2))
        color = torch.where(hit, val, color)
        best_t = torch.where(hit, tb, best_t)
    return color.reshape(n, cam.height, cam.width)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_frames(world: synth.World, cfg, poses: np.ndarray, device):
    """(N, 3) poses -> (front (N, H, W) uint8, bird (N, rows, cols) uint8), in
    host memory; rendered on ``device`` in chunks of ``CHUNK`` frames."""
    dw = DeviceWorld(world, device)
    rays_c = torch.as_tensor(synth._fisheye_rays(cfg), device=device)
    fronts, birds = [], []
    for i in range(0, len(poses), CHUNK):
        p = np.asarray(poses[i:i + CHUNK], np.float32)
        pt = torch.as_tensor(p, device=device)
        fronts.append(to_uint8(render_front(dw, cfg, p, rays_c)).cpu())
        birds.append(to_uint8(render_bird(dw, cfg, pt)).cpu())
    return torch.cat(fronts).numpy(), torch.cat(birds).numpy()
