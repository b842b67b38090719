"""Patch gather: the plain PyTorch version of
``fishbirdeyevisualslam_torch/ops/cuda_patch.py``, under the kernel's name."""

from __future__ import annotations

import torch


def extract_patches(img, yx, side: int):
    """``vmap(lambda p: lax.dynamic_slice(img, p, (side, side)))(yx)``: a
    negative corner counts from the end, then corners are clamped so every
    window lies inside ``img``."""
    h, w = img.shape
    y, x = yx[:, 0].long(), yx[:, 1].long()
    y = torch.where(y < 0, y + h, y).clamp(0, h - side)
    x = torch.where(x < 0, x + w, x).clamp(0, w - side)
    ar = torch.arange(side, device=img.device)
    rows = (y[:, None] + ar)[:, :, None]
    cols = (x[:, None] + ar)[:, None, :]
    return img[rows, cols]
