# Frozen copy of fishbirdeyevisualslam_torch/ops/features.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""ORB feature extraction: pyramid -> FAST -> grid-uniform top-k -> patches ->
orientation -> rBRIEF — the port of ``fishbirdeyevisualslam_tpu/ops/features.py``
(``ORBextractor::operator()``, ``ORBextractor.cc:1043-1105``).

Fixed output shapes, padded with a validity mask.  On the card, FAST + NMS of
every level of both views is one kernel launch (``ops/cuda_fast.py``) and each
view's patches come from one gather launch (``ops/cuda_patch.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from portbench.reference.config import OrbConfig
from portbench.reference.ops import cuda_fast, cuda_patch
from portbench.reference.ops import image as image_ops
from portbench.reference.ops import orb as orb_ops

_BLUR_R = 3  # Gaussian 7-tap radius for descriptor sampling


class Keypoints(NamedTuple):
    """Struct-of-arrays keypoint set, fixed capacity N (invalid slots masked)."""

    xy: torch.Tensor        # (N, 2) float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST ranking score (0 for invalid)
    angle: torch.Tensor     # (N,) float32 radians
    level: torch.Tensor     # (N,) int32 pyramid octave
    valid: torch.Tensor     # (N,) bool
    desc: torch.Tensor      # (N, 8) int32 packed rBRIEF (uint32 bits)
    desc_pm1: torch.Tensor  # (N, 256) bfloat16 +/-1


def stable_topk(x, k: int):
    """Top-k values and indices of a 1-D or row-batched tensor in descending
    order, ties going to the LOWER index (``lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_grid_topk(score, n_out: int, cell: int, margin: int):
    """Spatially uniform selection: per-cell top-4 candidates, then the global
    top ``n_out``.  Returns (yx (n_out, 2) int32, scores (n_out,), 0 where no
    corner)."""
    h, w = score.shape
    dev = score.device
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    ok = (row >= margin) & (row < h - margin) & (col >= margin) & (col < w - margin)
    score = torch.where(ok, score, torch.zeros_like(score))
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = F.pad(score, (0, pw, 0, ph))
    hh, ww = s.shape
    ncy, ncx = hh // cell, ww // cell
    cells = s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)
    vals, idx = stable_topk(cells, min(4, cell * cell))
    cid = torch.arange(ncy * ncx, device=dev)[:, None]
    iy = (cid // ncx) * cell + idx // cell
    ix = (cid % ncx) * cell + idx % cell
    flat_v, flat_y, flat_x = vals.reshape(-1), iy.reshape(-1), ix.reshape(-1)
    pad = n_out - flat_v.shape[0]
    if pad > 0:
        flat_v, flat_y, flat_x = (F.pad(t, (0, pad)) for t in (flat_v, flat_y, flat_x))
    top_v, top_i = stable_topk(flat_v, n_out)
    return torch.stack([flat_y[top_i], flat_x[top_i]], dim=-1).to(torch.int32), top_v


def _subpixel_offsets(score, yx):
    """Parabola interpolation of the score peak in each axis (the analog of
    cv::cornerSubPix, ``Frame.cc:349-352``)."""
    h, w = score.shape
    y = yx[:, 0].long().clamp(1, h - 2)
    x = yx[:, 1].long().clamp(1, w - 2)
    c = score[y, x]

    def off(m, p):
        denom = m - 2.0 * c + p
        o = 0.5 * (m - p) / torch.where(torch.abs(denom) < 1e-6,
                                        torch.full_like(denom, 1e-6), denom)
        return torch.clamp(o, -0.5, 0.5)

    return off(score[y - 1, x], score[y + 1, x]), off(score[y, x - 1], score[y, x + 1])


def _blur_patches(patches37):
    """(N, 37, 37) -> (N, 31, 31) separable 7-tap Gaussian (sigma 2), valid
    region only: the same pixels as a full-image GaussianBlur(7,7,2)
    (``ORBextractor.cc:1080-1100``) cut at the patches."""
    k = [float(v) for v in image_ops._gauss_kernel(2 * _BLUR_R + 1, 2.0)]
    P = orb_ops.PATCH
    x = sum(patches37[:, i: i + P, :] * k[i] for i in range(2 * _BLUR_R + 1))
    return sum(x[:, :, i: i + P] * k[i] for i in range(2 * _BLUR_R + 1))


def _detect_level(score, raw, cfg: OrbConfig, n_l: int):
    """Selection on one level's FAST maps: (yx, resp, valid, sub_dy, sub_dx)."""
    yx, resp = _select_grid_topk(score, n_l, cfg.grid_cell, orb_ops.HALF + 1)
    sub_dy, sub_dx = _subpixel_offsets(raw, yx)
    return yx, resp, resp > 0.0, sub_dy, sub_dx


PATCH37 = orb_ops.PATCH + 2 * _BLUR_R  # raw window around a keypoint: patch + blur taps


def level_atlas(pyr, yx_levels):
    """The vertical atlas of edge-padded level images (each padded by
    PATCH37 // 2) and the levels' keypoint corners (y, x) moved into it: a
    keypoint's PATCH37-wide window starts at its level coordinates."""
    pad = PATCH37 // 2
    heights = [p.shape[0] + 2 * pad for p in pyr]
    offs = [sum(heights[:l]) for l in range(len(pyr))]
    atlas = torch.zeros((sum(heights), max(p.shape[1] for p in pyr) + 2 * pad),
                        dtype=pyr[0].dtype, device=pyr[0].device)
    for l, p in enumerate(pyr):
        p_pad = F.pad(p[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
        atlas[offs[l]: offs[l] + p_pad.shape[0], : p_pad.shape[1]] = p_pad
    yx = torch.cat([torch.stack([yx_l[:, 0] + offs[l], yx_l[:, 1]], dim=-1)
                    for l, yx_l in enumerate(yx_levels)], dim=0)
    return atlas, yx


def _detect_patches(pyr, fast_maps, cfg: OrbConfig, n_features: int):
    """Selection + patch gather for one view, given its pyramid and per-level
    FAST maps: ONE (N, 37, 37) gather from the vertical atlas of edge-padded
    levels.  Returns ``(patches37, partial_kp)``; ``_describe_patches`` and
    ``_finish_keypoints`` fill in the rest."""
    budgets = image_ops.per_level_budget(n_features, cfg.n_levels, cfg.scale_factor)
    sels = [_detect_level(s, r, cfg, budgets[l]) for l, (s, r) in enumerate(fast_maps)]
    dev = pyr[0].device
    atlas, yx_all = level_atlas(pyr, [sel[0] for sel in sels])
    patches37 = cuda_patch.extract_patches(atlas, yx_all, PATCH37)

    xy0 = torch.cat([
        torch.stack([sels[l][0][:, 1].to(torch.float32) + sels[l][4],
                     sels[l][0][:, 0].to(torch.float32) + sels[l][3]], dim=-1)
        * (float(cfg.scale_factor) ** l)
        for l in range(len(pyr))], dim=0)
    resp = torch.cat([s[1] for s in sels])
    valid = torch.cat([s[2] for s in sels])
    lvl = torch.cat([torch.full((budgets[l],), l, dtype=torch.int32, device=dev)
                     for l in range(len(pyr))])
    kp = Keypoints(xy0, torch.where(valid, resp, torch.zeros_like(resp)), None, lvl, valid,
                   None, None)
    return patches37, kp


def _describe_patches(patches37):
    """Orientation + rBRIEF (gather sampler) over a (N, 37, 37) raw patch
    batch.  Returns (angle, packed, pm1)."""
    patches = patches37[:, _BLUR_R: _BLUR_R + orb_ops.PATCH, _BLUR_R: _BLUR_R + orb_ops.PATCH]
    ang = orb_ops.orientations(patches)
    bits = orb_ops.descriptors(_blur_patches(patches37), ang)
    return ang, orb_ops.pack_bits(bits), orb_ops.bits_to_pm1(bits)


def _finish_keypoints(kp: Keypoints, ang, packed, pm1, img_shape,
                      detection_mask=None) -> Keypoints:
    """Attach descriptors (zeroed on invalid slots, so they never match) and
    apply the detection-mask gate."""
    valid = kp.valid
    packed = torch.where(valid[:, None], packed, torch.zeros_like(packed))
    pm1 = torch.where(valid[:, None], pm1, torch.zeros_like(pm1))
    kp = kp._replace(angle=ang, desc=packed, desc_pm1=pm1)
    if detection_mask is not None:
        xi = kp.xy[:, 0].to(torch.int32).clamp(0, img_shape[1] - 1).long()
        yi = kp.xy[:, 1].to(torch.int32).clamp(0, img_shape[0] - 1).long()
        inside = detection_mask[yi, xi]
        kp = kp._replace(valid=kp.valid & inside,
                         response=torch.where(inside, kp.response, torch.zeros_like(kp.response)))
    return kp


def extract_dual(img_a, img_b, cfg: OrbConfig, n_a: int, n_b: int, mask_b=None):
    """Front + bird extraction.  FAST runs once over every level of both
    pyramids, each view's patches are gathered once, and orientation + rBRIEF
    run once over both views' patch batches."""
    pyr_a = image_ops.build_pyramid(img_a.to(torch.float32).contiguous(), cfg.n_levels,
                                    cfg.scale_factor)
    pyr_b = image_ops.build_pyramid(img_b.to(torch.float32).contiguous(), cfg.n_levels,
                                    cfg.scale_factor)
    maps = cuda_fast.fast_detect_levels(pyr_a + pyr_b, float(cfg.ini_th_fast),
                                        float(cfg.min_th_fast))
    pa, kpa = _detect_patches(pyr_a, maps[: cfg.n_levels], cfg, n_a)
    pb, kpb = _detect_patches(pyr_b, maps[cfg.n_levels:], cfg, n_b)
    ang, packed, pm1 = _describe_patches(torch.cat([pa, pb], dim=0))
    na = pa.shape[0]
    kp_a = _finish_keypoints(kpa, ang[:na], packed[:na], pm1[:na], img_a.shape, None)
    kp_b = _finish_keypoints(kpb, ang[na:], packed[na:], pm1[na:], img_b.shape, mask_b)
    return kp_a, kp_b
