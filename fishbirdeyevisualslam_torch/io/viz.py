"""Offline visualization — the port of ``fishbirdeyevisualslam_tpu/io/viz.py``,
the metric-path-free analog of the reference's Pangolin/OpenCV/PCL viewers
(``Viewer.cc``, ``MapDrawer.cc``, ``FrameDrawer.cc``).

The reference renders live GL windows; on a headless host the equivalent is
image export: the frame overlays, and a top-down map of the points, the
keyframe trajectory with its covisibility edges and the estimate against
ground truth (the reference's two PCL viewers, ``Tracking.cc:2569-2624``).
Everything is numpy on the host: the tensors are copied off the device, and
PNGs are written by a small encoder (``write_png``), with no plotting
library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# overlay colors (RGB)
_GREEN = np.array([40, 220, 60], np.uint8)    # tracked map point
_BLUE = np.array([80, 140, 255], np.uint8)    # detected, unmatched
_ORANGE = np.array([255, 160, 40], np.uint8)  # bird match
_RED = np.array([230, 60, 60], np.uint8)      # contour edge recolor


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG: one IDAT chunk of
    zlib-deflated scanlines, each with filter type 0."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def _gray_to_rgb(gray) -> np.ndarray:
    g = _host(gray).astype(np.float32)
    g = np.clip(g, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw_squares(rgb: np.ndarray, uv: np.ndarray, color: np.ndarray,
                  half: int = 3) -> None:
    """Rasterize hollow squares around keypoints in-place (the reference draws
    ``cv::rectangle`` + ``cv::circle`` per keypoint, ``FrameDrawer.cc:83-116``)."""
    h, w = rgb.shape[:2]
    for u, v in uv:
        x, y = int(round(u)), int(round(v))
        x0, x1 = max(x - half, 0), min(x + half, w - 1)
        y0, y1 = max(y - half, 0), min(y + half, h - 1)
        if x1 <= x0 or y1 <= y0:
            continue
        rgb[y0, x0:x1 + 1] = color
        rgb[y1, x0:x1 + 1] = color
        rgb[y0:y1 + 1, x0] = color
        rgb[y0:y1 + 1, x1] = color


def draw_frame_overlay(front_gray, uv, matched_mask, valid_mask,
                       state: int = 1, n_tracked: int | None = None) -> np.ndarray:
    """``FrameDrawer::DrawFrame`` analog (``FrameDrawer.cc:40-128``): the front
    image with green squares on features matched to map points and blue on
    unmatched detections, plus a status strip.  Returns an (H+20, W, 3) uint8
    RGB image."""
    rgb = _gray_to_rgb(front_gray)
    uv = _host(uv)
    matched = _host(matched_mask).astype(bool)
    valid = _host(valid_mask).astype(bool)
    _draw_squares(rgb, uv[valid & ~matched], _BLUE, half=2)
    _draw_squares(rgb, uv[valid & matched], _GREEN, half=3)
    # status strip: the state as the strip's colour and the tracked count as
    # the length of a bar (the reference rasterizes text with cv::putText)
    strip = np.zeros((20, rgb.shape[1], 3), np.uint8)
    strip[:] = {0: (90, 90, 90), 1: (30, 120, 30), 2: (140, 40, 40)}.get(
        int(state), (90, 90, 90))
    n = int(matched[valid].sum()) if n_tracked is None else int(n_tracked)
    px = min(max(n * 2, 0), rgb.shape[1])
    strip[6:14, :px] = (230, 230, 230)
    return np.concatenate([rgb, strip], axis=0)


def draw_bird_overlay(bird_gray, bird_uv, matched_mask, valid_mask,
                      contour=None) -> np.ndarray:
    """``FrameDrawer::DrawBird``/``DrawBirdMatches`` analog
    (``FrameDrawer.cc:130-224``): bird view with contour edges recolored red
    and matched bird keypoints in orange, detections in blue."""
    rgb = _gray_to_rgb(bird_gray)
    if contour is not None:
        edge = _host(contour) < 150
        rgb[edge] = (rgb[edge] // 2) + _RED // 2
    uv = _host(bird_uv)
    matched = _host(matched_mask).astype(bool)
    valid = _host(valid_mask).astype(bool)
    _draw_squares(rgb, uv[valid & ~matched], _BLUE, half=2)
    _draw_squares(rgb, uv[valid & matched], _ORANGE, half=3)
    return rgb


class FrameDrawer:
    """Per-frame overlay exporter — the reference ``FrameDrawer`` snapshots the
    Tracking state each frame (``FrameDrawer::Update``, ``FrameDrawer.cc:264``)
    and the Viewer renders it; here ``update()`` snapshots ``SlamSystem`` and
    ``save()`` writes a side-by-side front|bird PNG."""

    def __init__(self):
        self._front = None
        self._bird = None

    def update(self, system, front_gray, bird_gray, contour=None):
        f = system.last_frame
        if f is None:
            return
        assoc = system.last_assoc
        fm = (_host(assoc.mp_idx) >= 0) if assoc is not None \
            else np.zeros(_host(f.uv_raw).shape[0], bool)
        bm = (_host(assoc.bp_idx) >= 0) if assoc is not None \
            else np.zeros(_host(f.bird_uv).shape[0], bool)
        self._front = draw_frame_overlay(
            front_gray, f.uv_raw, fm, f.kp_valid, state=system.state)
        self._bird = draw_bird_overlay(
            bird_gray, f.bird_uv, bm, f.bird_kp_valid, contour=contour)

    def canvas(self) -> np.ndarray | None:
        """The front overlay and the bird overlay side by side, top-aligned on
        black (None before the first ``update``)."""
        if self._front is None:
            return None
        hf, wf = self._front.shape[:2]
        hb, wb = self._bird.shape[:2]
        canvas = np.zeros((max(hf, hb), wf + wb, 3), np.uint8)
        canvas[:hf, :wf] = self._front
        canvas[:hb, wf:] = self._bird
        return canvas

    def save(self, path: str) -> None:
        canvas = self.canvas()
        if canvas is not None:
            write_png(path, canvas)


# ---------------------------------------------------------------------------
# the top-down map
# ---------------------------------------------------------------------------

MAP_PX = 1170       # canvas side: the JAX figure's 9 in at 130 dpi
_GREY = (0x88, 0x88, 0x88)      # map points
_BIRD = (0x22, 0xaa, 0x77)      # bird points ("#2a7")
_EDGE = (0xcc, 0xdd, 0xee)      # covisibility edges
_KF = (0x00, 0x66, 0xcc)        # keyframes ("#06c")
_EST = (0xee, 0x66, 0x00)       # the frame estimate ("#e60")
_GT = (0x00, 0xaa, 0x00)        # ground truth ("#0a0")


class _Canvas:
    """A white square canvas with a metric frame fitted to the content."""

    def __init__(self, xy_all: np.ndarray, size: int = MAP_PX, margin: int = 20):
        self.img = np.full((size, size, 3), 255, np.uint8)
        lo = xy_all.min(axis=0) if len(xy_all) else np.zeros(2)
        hi = xy_all.max(axis=0) if len(xy_all) else np.ones(2)
        span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
        self.scale = (size - 2 * margin - 1) / span           # equal aspect
        self.center = (lo + hi) / 2.0
        self.size = size

    def pix(self, xy: np.ndarray) -> np.ndarray:
        """Metric (x right, y up) to integer pixel (col, row)."""
        c = (xy[:, 0] - self.center[0]) * self.scale + self.size / 2.0
        r = self.size / 2.0 - (xy[:, 1] - self.center[1]) * self.scale
        return np.stack([np.round(c), np.round(r)], -1).astype(np.int64)

    def dots(self, xy: np.ndarray, color, radius: int = 0) -> None:
        p = self.pix(xy)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                c, r = p[:, 0] + dx, p[:, 1] + dy
                ok = (c >= 0) & (c < self.size) & (r >= 0) & (r < self.size)
                self.img[r[ok], c[ok]] = color

    def polyline(self, xy: np.ndarray, color, dashed: bool = False) -> None:
        p = self.pix(xy).astype(np.float64)
        for a, b in zip(p[:-1], p[1:]):
            n = int(max(abs(b - a).max(), 1))
            t = np.linspace(0.0, 1.0, n + 1)
            if dashed:   # 6 px on, 4 px off
                t = t[(np.arange(n + 1) % 10) < 6]
            pts = np.round(a[None] + t[:, None] * (b - a)[None]).astype(np.int64)
            ok = (pts[:, 0] >= 0) & (pts[:, 0] < self.size) & (pts[:, 1] >= 0) \
                & (pts[:, 1] < self.size)
            self.img[pts[ok, 1], pts[ok, 0]] = color


def plot_map(m, cfg, path: str, gt_se2=None, est_Twb=None) -> None:
    """Top-down map image (PNG): front points in grey and bird points in
    green in the first base frame, covisibility edges (count >= 15) in pale
    blue, the keyframes as a blue polyline with dots, the frame estimate in
    orange and the ground truth (relative to its start) dashed in green —
    the JAX package's figure, drawn on a numpy canvas."""
    from fishbirdeyevisualslam_torch.geometry import ipm, se3
    from fishbirdeyevisualslam_torch.slam import map_state as ms

    dev = m.mp_pos.device
    # the world is the first camera frame; project it to the first base frame
    Tbc = ipm.extrinsics_Tbc(cfg.extrinsics, device=dev)
    mp = _host(se3.transform(Tbc, m.mp_pos[m.mp_valid]))
    bp = _host(se3.transform(Tbc, m.bp_pos[m.bp_valid]))
    valid = _host(m.kf_valid).astype(bool)
    idx = [k for k in range(int(m.n_kf)) if valid[k]]
    kf_xy = np.zeros((0, 2))
    if idx:
        Twb = ipm.Twb_from_Twc(cfg.extrinsics, se3.inverse(m.kf_Tcw[idx]))
        kf_xy = _host(Twb)[:, 4:6]
    layers = [mp[:, :2], bp[:, :2], kf_xy]
    if est_Twb is not None:
        layers.append(np.asarray(est_Twb)[:, 4:6])
    gt_xy = None
    if gt_se2 is not None:
        gt_se2 = np.asarray(gt_se2)
        gt_xy = gt_se2[:, :2] - gt_se2[:1, :2]
        layers.append(gt_xy)
    cv = _Canvas(np.concatenate(layers, axis=0))
    if len(mp):
        cv.dots(mp[:, :2], _GREY)
    if len(bp):
        cv.dots(bp[:, :2], _BIRD)
    if idx:
        C = _host(ms.covisibility_counts(m))
        for a_i, a in enumerate(idx):
            for b_i, b in enumerate(idx):
                if b > a and C[a, b] >= 15:
                    cv.polyline(kf_xy[[a_i, b_i]], _EDGE)
        cv.polyline(kf_xy, _KF)
        cv.dots(kf_xy, _KF, radius=2)
    if est_Twb is not None:
        cv.polyline(np.asarray(est_Twb)[:, 4:6], _EST)
    if gt_xy is not None:
        cv.polyline(gt_xy, _GT, dashed=True)
    write_png(path, cv.img)
