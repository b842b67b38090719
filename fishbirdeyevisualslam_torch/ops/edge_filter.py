"""IPM edge filtering — the port of ``fishbirdeyevisualslam_tpu/ops/edge_filter.py``,
the analog of the reference's ``EdgeFilterIPM`` (``src/edge_filter_ipm.cpp``).

The reference pipeline (``EdgeFilterIPM::process``, method 3 — the one
``simple_birdseye_odometer.cpp:80`` uses):

  1. 3x3 blur -> Otsu threshold -> Canny(otsu/2, otsu) on the birdseye image
     (``edge_filter_ipm.cpp:108-122``); Canny(50, 100) on the freespace image;
  2. freespace mask (>50) eroded 7x7, then the per-camera view mask
     (``:129-144``);
  3. IPM-artifact removal: radial streaks pointing at the per-camera IPM
     focal points are deleted (``remove_ipm_edge_by_contour_orientation``,
     ``:306-410``);
  4. small-edge removal (<20-pixel contours, ``:411-431``);
  5. merged = 0.5 * birdseye_edges + 1.0 * freespace_edges (``:193-196``).

Everything is fixed-shape tensor work in plain PyTorch, with the JAX
package's semantics:

  * Canny = Sobel -> 4-direction non-maximum suppression -> hysteresis as a
    fixed count of mask dilations (16 sweeps cover any weak chain up to 16
    px from a strong seed);
  * Otsu = 256-bin histogram + argmax of the between-class variance;
  * a "contour segment aimed at the focal point" is a pixel whose tangent
    (perpendicular to the Sobel gradient) lies within the angle threshold of
    its focal ray; the segment-length gate becomes a component-size gate;
  * component size = a fixed count of min-label sweeps + a count per label
    (components merge up to the sweep radius: an under-estimate for long
    snaking components, exact for thresholds well below the sweep count).

The sweep counts are the semantics; the sweeps run back to back on the
device with no host read between them.  Floating-point steps follow the JAX
package's as XLA's CPU backend evaluates them (the blur's summation order,
its ``hypot``, its prefix sum), and the roots and angles are the correctly
rounded float32 values (``sqrt_f32``, ``atan2_f32``) on the CPU and on the
card alike, so that the edge maps are equal: a blur that differs in its last
bits moves the Otsu threshold of some renders by a grey level.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fishbirdeyevisualslam_torch.device import const

# view order: front, rear, left, right (edge_filter_ipm.cpp:5-11)
VIEW_INTENSITIES = (50, 100, 150, 200)
FOCAL_POINT_X = (189, 187, 164, 217)
FOCAL_POINT_Y = (128, 248, 178, 176)


def box_blur3(img):
    """3x3 box blur with zero padding (``blur(birdseye_img_, Size(3,3))``).
    The nine products are summed in the order XLA's CPU convolution sums the
    JAX package's (taps t = 3 dy + dx: ((t0 + t1) + (t4 + t5)) + ((t2 + t3)
    + (t6 + t7)), then t8), so that the blur rounds as it does."""
    p = F.pad(img, (1, 1, 1, 1))
    H, W = img.shape
    t = [p[dy:dy + H, dx:dx + W] * (1.0 / 9.0) for dy in range(3) for dx in range(3)]
    return (((t[0] + t[1]) + (t[4] + t[5])) + ((t[2] + t[3]) + (t[6] + t[7]))) + t[8]


def _prefix_sum(x, block: int = 16):
    """Inclusive prefix sum of a 1-D tensor whose length is a multiple of
    ``block``, summed as XLA's CPU backend sums the JAX package's
    ``jnp.cumsum`` of 256 bins: sequentially within blocks of 16, the blocks'
    totals sequentially, then each block's offset added.  The same additions
    in the same order give the same rounding (``torch.cumsum`` accumulates in
    double on the CPU)."""
    rows = x.reshape(-1, block)
    cols = [rows[:, 0]]
    for i in range(1, block):
        cols.append(cols[-1] + rows[:, i])
    within = torch.stack(cols, 1)
    offs = [torch.zeros_like(within[0, 0])]
    for b in range(1, rows.shape[0]):
        offs.append(offs[-1] + within[b - 1, -1])
    return (torch.stack(offs)[:, None] + within).reshape(-1)


def otsu_threshold(img):
    """Otsu's threshold over a 256-bin histogram (maximize between-class
    variance) — ``threshold(..., CV_THRESH_OTSU)``; a 0-d float32 tensor."""
    v = torch.clamp(img, 0.0, 255.0)
    hist = torch.zeros(256, dtype=torch.float32, device=img.device).index_add_(
        0, v.to(torch.int64).reshape(-1),
        torch.ones(v.numel(), dtype=torch.float32, device=img.device))
    p = hist / torch.clamp(hist.sum(), min=1.0)
    w0 = _prefix_sum(p)                      # class-0 weight for t = 0..255
    mu = _prefix_sum(p * torch.arange(256, dtype=torch.float32, device=img.device))
    mu_t = mu[-1]
    w1 = 1.0 - w0
    between = torch.where((w0 > 0) & (w1 > 0), (mu_t * w0 - mu) ** 2 / (w0 * w1 + 1e-12),
                          torch.zeros_like(w0))
    return torch.argmax(between).to(torch.float32)


def _shift(x, dy: int, dx: int, fill):
    """Neighbour shift by at most one pixel with constant fill at the borders
    (never a wrap-around: that would make opposite borders neighbours);
    ``result[i, j] = x[i - dy, j - dx]``."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[1 - dy:1 - dy + H, 1 - dx:1 - dx + W]


def _sobel(img):
    gx = (img[1:-1, 2:] - img[1:-1, :-2]) * 2.0 \
        + (img[:-2, 2:] - img[:-2, :-2]) + (img[2:, 2:] - img[2:, :-2])
    gy = (img[2:, 1:-1] - img[:-2, 1:-1]) * 2.0 \
        + (img[2:, :-2] - img[:-2, :-2]) + (img[2:, 2:] - img[:-2, 2:])
    return F.pad(gx, (1, 1, 1, 1)), F.pad(gy, (1, 1, 1, 1))


def sqrt_f32(x):
    """The correctly rounded float32 square root.  ``torch.sqrt`` of float32
    on the CPU is a vectorized approximation (one ulp off for 0.04-0.7% of
    the inputs measured) and the card's is exact: the root taken in float64
    and rounded is the exact one on both."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def atan2_f32(y, x):
    """float32 ``atan2`` evaluated in float64 and rounded: the CPU's and the
    card's float32 ``atan2`` differ by an ulp here and there, their float64
    results round to the same float32."""
    return torch.atan2(y.to(torch.float64), x.to(torch.float64)).to(torch.float32)


def _hypot(x1, x2):
    """``jnp.hypot``'s formula: max * sqrt(1 + (min / max)^2)."""
    x1, x2 = torch.abs(x1), torch.abs(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    zero = hi == 0
    r = hi * sqrt_f32(1 + torch.square(lo / torch.where(zero, torch.ones_like(hi), hi)))
    return torch.where(zero, hi, r)


def _dilate(mask):
    """OR over each pixel's 3x3 neighbourhood, False beyond the borders."""
    return F.max_pool2d(mask.to(torch.float32)[None, None], 3, stride=1, padding=1)[0, 0] > 0


def canny(img, lo, hi, hysteresis_iters: int = 16):
    """Canny edges: Sobel -> 4-direction NMS -> double threshold -> bounded
    hysteresis (a fixed count of dilations of the strong set through the
    weak set).  Returns (edges bool, gx, gy)."""
    gx, gy = _sobel(img)
    mag = _hypot(gx, gy)
    # quantize the gradient direction to 0/45/90/135 degrees and compare the
    # two neighbours along it
    ang = atan2_f32(gy, gx)  # [-pi, pi]
    a = torch.remainder(ang * (180.0 / math.pi) + 180.0, 180.0)
    d0 = (a < 22.5) | (a >= 157.5)          # horizontal gradient -> E/W neighbours
    d1 = (a >= 22.5) & (a < 67.5)           # diagonal
    d2 = (a >= 67.5) & (a < 112.5)          # vertical

    def sh(dy, dx):
        return _shift(mag, dy, dx, 0.0)

    n1 = torch.where(d0, sh(0, 1), torch.where(d1, sh(1, 1), torch.where(d2, sh(1, 0), sh(1, -1))))
    n2 = torch.where(d0, sh(0, -1), torch.where(d1, sh(-1, -1),
                                                torch.where(d2, sh(-1, 0), sh(-1, 1))))
    is_max = (mag >= n1) & (mag >= n2)
    strong = is_max & (mag >= hi)
    weak = is_max & (mag >= lo)
    for _ in range(hysteresis_iters):
        strong = (_dilate(strong) & weak) | strong
    return strong, gx, gy


def erode(mask, radius: int):
    """Rectangular erosion over a (2 radius + 1)^2 window
    (``getStructuringElement(MORPH_RECT, ...)``), False beyond the borders.
    The JAX package's erosion is 3x3 whatever the radius: its ``_shift``
    pads by one pixel, and ``lax.dynamic_slice`` clamps the larger shifts
    back to one; this one erodes the reference's 7x7 at radius 3."""
    k = 2 * radius + 1
    outside = F.pad((~mask).to(torch.float32)[None, None], (radius,) * 4, value=1.0)
    return (F.max_pool2d(outside, k, stride=1)[0, 0] == 0) & mask


def component_sizes(mask, n_sweeps: int = 48):
    """Approximate connected-component sizes (8-connectivity) by min-label
    propagation: each pixel starts with its flat index; ``n_sweeps`` 3x3 min
    sweeps spread the minimum; a count per final label gives the sizes.
    Components whose geodesic diameter exceeds ``n_sweeps`` fragment into
    pieces of at least that diameter — an under-estimate never below
    ~n_sweeps pixels, so thresholds << n_sweeps are exact."""
    H, W = mask.shape
    dev = mask.device
    big = float(H * W)
    # labels up to H*W are exact in float32 (below 2^24), where max pooling runs
    idx = torch.arange(H * W, dtype=torch.float32, device=dev).reshape(H, W)
    neg = torch.where(mask, -idx, -big)[None, None]
    for _ in range(n_sweeps):
        neg = torch.where(mask, F.max_pool2d(neg, 3, stride=1, padding=1), -big)
    lab = (-neg[0, 0]).to(torch.int64)
    sizes = torch.zeros(H * W + 1, dtype=torch.int32, device=dev).index_add_(
        0, lab.reshape(-1), mask.reshape(-1).to(torch.int32))
    return sizes[lab]


def default_view_index(shape, device=None):
    """Per-pixel view index when no stitch mask is given: the 4-quadrant
    diagonal split of a surround view (front/rear/left/right wedges)."""
    H, W = shape
    r = torch.arange(H, device=device)[:, None] - H / 2.0
    c = torch.arange(W, device=device)[None, :] - W / 2.0
    front = r <= -torch.abs(c) * (H / W)
    rear = r >= torch.abs(c) * (H / W)
    left = (~front) & (~rear) & (c < 0)
    return torch.where(front, 0, torch.where(rear, 1, torch.where(left, 2, 3))).to(torch.int32)


def view_index_from_mask(view_mask):
    """Per-pixel view index from the dataset's intensity-coded stitch mask."""
    vi = torch.zeros(view_mask.shape, dtype=torch.int32, device=view_mask.device)
    for i, inten in enumerate(VIEW_INTENSITIES):
        vi = torch.where(torch.abs(view_mask - inten) < 10, i, vi).to(torch.int32)
    return vi


def remove_radial_artifacts(edge, gx, gy, angle_thresh_deg: float,
                            view_idx=None, focal_xy=None, min_len: int = 20):
    """``remove_ipm_edge_by_contour_orientation`` analog: delete edge pixels
    whose local tangent (perpendicular to the gradient) points at the view's
    IPM focal point within ``angle_thresh_deg``, when they belong to an
    aligned structure at least ``min_len/2`` pixels long (the reference's
    ``2*|seg| > 0.5*min_len`` gate on approxPolyDP segments)."""
    H, W = edge.shape
    dev = edge.device
    if view_idx is None:
        view_idx = default_view_index((H, W), dev)
    if focal_xy is None:
        focal_xy = const(tuple(zip(FOCAL_POINT_X, FOCAL_POINT_Y)), torch.float32, dev)
    vi = view_idx.long()
    fx = focal_xy[vi, 0]
    fy = focal_xy[vi, 1]
    rr = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cc = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ray = atan2_f32(fy - rr, fx - cc)
    tangent = atan2_f32(gx, -gy)  # perpendicular to the gradient
    dang = torch.abs(torch.remainder(tangent - ray + math.pi / 2, math.pi) - math.pi / 2)
    # the threshold in radians as float32 rounds it (a float32 value, exact as a float)
    thresh = float(np.float32(angle_thresh_deg) * np.float32(math.pi / 180.0))
    aligned = edge & (dang < thresh)
    long_enough = component_sizes(aligned) >= max(1, min_len // 2)
    return edge & ~(aligned & long_enough)


def remove_small_edges(edge, min_size: int = 20):
    """``remove_small_edges``: drop components shorter than ``min_size``."""
    return edge & (component_sizes(edge) >= min_size)


def filter_ipm_edges(bird_img, freespace_img, view_mask=None):
    """Full ``EdgeFilterIPM::process(method=3)``: returns (merged (H, W) f32
    edge weights, bird_edges bool, free_edges bool), with ``merged = 0.5 *
    bird + 1.0 * freespace`` like the reference's ``addWeighted``
    (``edge_filter_ipm.cpp:193-196``).  Runs where its inputs lie."""
    blur = box_blur3(bird_img)
    otsu = otsu_threshold(blur)
    # OpenCV's Canny compares the unnormalized Sobel magnitude against the
    # thresholds directly: the same here, (otsu/2, otsu) and (50, 100)
    bird_edge, gx, gy = canny(blur, 0.5 * otsu, otsu)
    free_edge, fgx, fgy = canny(freespace_img, 50.0, 100.0)

    fmask = erode(freespace_img > 50.0, 3)
    vi = None if view_mask is None else view_index_from_mask(view_mask)
    bird_edge = bird_edge & fmask
    free_edge = free_edge & fmask
    bird_edge = remove_radial_artifacts(bird_edge, gx, gy, 15.0, vi, min_len=20)
    free_edge = remove_radial_artifacts(free_edge, fgx, fgy, 15.0, vi, min_len=20)
    bird_edge = remove_small_edges(bird_edge, 20)
    merged = 0.5 * bird_edge.to(torch.float32) + 1.0 * free_edge.to(torch.float32)
    return merged, bird_edge, free_edge
