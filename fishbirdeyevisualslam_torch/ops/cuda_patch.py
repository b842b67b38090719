"""Patch gather: the wrapper of kernel ``csrc/patch.cu`` and its plain
PyTorch version.

Replaces ``fishbirdeyevisualslam_tpu/ops/pallas_patch.py:extract_patches``.
The wrapper launches the kernel for CUDA tensors and runs
``extract_patches_plain`` for CPU tensors; there is no other fall-back.
"""

from __future__ import annotations

import ctypes

import torch

from fishbirdeyevisualslam_torch import _cuda


def extract_patches_plain(img, yx, side: int):
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


def extract_patches(img, yx, side: int):
    """(H, W) f32 image, (N, 2) int32 top-left corners -> (N, side, side) f32."""
    if img.device.type == "cpu" and yx.device.type == "cpu":
        return extract_patches_plain(img, yx, side)
    if img.device.type != "cuda" or yx.device != img.device:
        raise ValueError("extract_patches: img and yx must lie on one CUDA device")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("extract_patches: img must be a contiguous 2-D float32 tensor")
    if yx.dtype != torch.int32 or yx.dim() != 2 or yx.shape[1] != 2 or not yx.is_contiguous():
        raise ValueError("extract_patches: yx must be a contiguous (N, 2) int32 tensor")
    h, w = img.shape
    if not 1 <= side <= min(h, w):
        raise ValueError(f"extract_patches: side {side} does not fit a {h}x{w} image")
    n = yx.shape[0]
    out = torch.empty((n, side, side), dtype=torch.float32, device=img.device)
    fn = _cuda.load("patch").extract_patches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), h, w, yx.data_ptr(), n, side, out.data_ptr(), stream)
    _cuda.check(err, "extract_patches")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
