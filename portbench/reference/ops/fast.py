# Frozen copy of fishbirdeyevisualslam_torch/ops/fast.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""FAST-9/16 corner detection as whole-image tensor ops — the port of
``fishbirdeyevisualslam_tpu/ops/fast.py`` and the plain version of the
FAST + NMS kernel (``ops/cuda_fast.py``).

For every pixel: the 16 Bresenham-circle differences, bright/dark bitmasks,
a cyclic run-of->=9 test, a score equal to the summed excess over the
threshold, a 3-px interior mask and a 3x3 non-max suppression.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock ((dy, dx)).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

BONUS = 1e4  # ranking bonus of strict-threshold corners


def _has_arc9(bits):
    """(H, W) int32 bitfield of 16 circle bits -> bool: any cyclic run >= 9."""
    m = bits | (bits << 16)
    r2 = m & (m >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (m >> 8)
    return (r9 & 0xFFFF) != 0


def _circle_stack(img):
    """(16, H, W): the intensity at each circle offset (rolled, so it wraps;
    the caller masks the 3-px border)."""
    return torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
                        for dy, dx in CIRCLE])


def fast_score_maps(img, thresholds):
    """(score, is_corner) maps for several thresholds from one set of circle
    differences.  The 16 terms are summed in circle order."""
    img = img.to(torch.float32)
    h, w = img.shape
    d = _circle_stack(img) - img
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    interior = (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    zero = torch.zeros_like(img)
    out = []
    for t in thresholds:
        bits_b = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
        bits_d = torch.zeros_like(bits_b)
        score_b = zero
        score_d = zero
        for i, di in enumerate(d):
            bright = di > t
            dark = di < -t
            bits_b = bits_b | (bright.to(torch.int32) << i)
            bits_d = bits_d | (dark.to(torch.int32) << i)
            score_b = score_b + torch.where(bright, di - t, zero)
            score_d = score_d + torch.where(dark, -di - t, zero)
        corner = (_has_arc9(bits_b) | _has_arc9(bits_d)) & interior
        out.append((torch.where(corner, torch.maximum(score_b, score_d), zero), corner))
    return out


def nms3x3(score):
    """Keep only 3x3 local maxima (OpenCV FAST nonmaxSuppression)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= mx) & (score > 0), score, torch.zeros_like(score))


def detect(img, ini_threshold: float, min_threshold: float, with_raw: bool = False):
    """Two-threshold FAST: strict-pass corners carry a +1e4 ranking bonus,
    weak corners fill elsewhere; returns the NMS'd score map (0 = no corner)
    and, with ``with_raw``, the pre-NMS low-threshold score map."""
    (s_hi, _), (s_lo, _) = fast_score_maps(img, (ini_threshold, min_threshold))
    score = torch.where(s_hi > 0, s_hi + BONUS, s_lo)
    out = nms3x3(score)
    if with_raw:
        return out, s_lo
    return out
