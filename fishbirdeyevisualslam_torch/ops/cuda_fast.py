"""FAST + NMS over all pyramid levels of a frame: the wrapper of kernel
``csrc/fast.cu`` and its plain PyTorch version.

Replaces ``fishbirdeyevisualslam_tpu/ops/pallas_fast.py:fast_detect``.  The
wrapper launches the kernel for CUDA tensors and runs ``fast_detect_levels_plain``
for CPU tensors; there is no other fall-back.
"""

from __future__ import annotations

import ctypes

import torch

from fishbirdeyevisualslam_torch import _cuda
from fishbirdeyevisualslam_torch.ops import fast as fast_ops

MAX_LEVELS = 32


def fast_detect_levels_plain(levels, th_hi: float, th_lo: float):
    """``[fast.detect(img, th_hi, th_lo, with_raw=True) for img in levels]``."""
    return [fast_ops.detect(img, th_hi, th_lo, with_raw=True) for img in levels]


def fast_detect_levels(levels, th_hi: float, th_lo: float):
    """(NMS'd score, raw low-threshold score) per level image, both (H, W) f32.

    One kernel launch covers every level: the kernel reads a level table of
    the images' own pointers and writes both maps into flat buffers."""
    if all(img.device.type == "cpu" for img in levels):
        return fast_detect_levels_plain(levels, th_hi, th_lo)
    dev = levels[0].device
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_detect_levels takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    for img in levels:
        if img.device != dev or img.device.type != "cuda":
            raise ValueError("fast_detect_levels: all levels must lie on one CUDA device")
        if img.dtype != torch.float32 or img.dim() != 2 or img.numel() == 0 \
                or not img.is_contiguous():
            raise ValueError("fast_detect_levels: levels must be non-empty, contiguous 2-D "
                             "float32 tensors")
    sizes = [img.numel() for img in levels]
    if sum(sizes) >= 2**31:
        raise ValueError("fast_detect_levels: more than 2**31 pixels")
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    score = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    raw = torch.empty_like(score)
    n = len(levels)
    arr = ctypes.c_int * n
    lib = _cuda.load("fast")
    fn = lib.fast_levels
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ip, ip, ip, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn((ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
                 score.data_ptr(), raw.data_ptr(), n,
                 arr(*offs), arr(*[img.shape[0] for img in levels]),
                 arr(*[img.shape[1] for img in levels]),
                 float(th_hi), float(th_lo), stream)
    _cuda.check(err, "fast_levels")
    fast_detect_levels.launches += 1
    return [(score[o:o + s].view(img.shape), raw[o:o + s].view(img.shape))
            for o, s, img in zip(offs, sizes, levels)]


fast_detect_levels.launches = 0
