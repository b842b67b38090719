# Frozen copy of fishbirdeyevisualslam_torch/ops/image.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Image primitives — the port of ``fishbirdeyevisualslam_tpu/ops/image.py``:
grayscale, resize pyramid, per-level feature budgets, separable Gaussian blur.

Images are float32 (0..255), shape (H, W).
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from portbench.reference.device import table


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    return [(int(round(h / scale**i)), int(round(w / scale**i))) for i in range(n_levels)]


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., method="linear")``
    along one axis: the triangle kernel, widened by the downsampling factor
    (antialiasing), each output column normalised to sum 1, samples outside
    the input zeroed.  Plain bilinear resampling (``F.interpolate``) does not
    antialias and so differs from it; these weights, applied as two f32
    matmuls, reproduce it (``tests/test_torch_extract.py``).  Computed in
    float32 in the order of ``jax._src.image.scale.compute_weight_mat`` as XLA
    compiles it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one multiply-add with a single
    # rounding; the float64 product reproduces it
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0) * f32(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(img, out_h: int, out_w: int):
    """``jax.image.resize(img, (out_h, out_w), "linear")``: Whᵀ · img · Ww in f32."""
    h, w = img.shape
    out = img
    if out_h != h:
        out = table(resize_weights, (h, out_h), torch.float32, img.device).T @ out
    if out_w != w:
        out = out @ table(resize_weights, (w, out_w), torch.float32, img.device)
    return out


def build_pyramid(img, n_levels: int, scale: float):
    """List of n_levels images, level i downscaled by scale**i."""
    h, w = img.shape
    out = [img]
    for lh, lw in pyramid_shapes(h, w, n_levels, scale)[1:]:
        out.append(resize(img, lh, lw))
    return out


@functools.lru_cache(maxsize=8)
def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def per_level_budget(n_features: int, n_levels: int, scale: float) -> List[int]:
    """Feature budget per pyramid level with geometric decay 1/scale; the
    rounding leftovers go to the finest levels."""
    inv = 1.0 / scale
    total = sum(inv**i for i in range(n_levels))
    raw = [n_features * (inv**i) / total for i in range(n_levels)]
    out = [int(math.floor(r)) for r in raw]
    deficit = n_features - sum(out)
    for i in range(deficit):
        out[i % n_levels] += 1
    return out
