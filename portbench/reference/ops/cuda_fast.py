"""FAST + NMS over all pyramid levels: the plain PyTorch version of
``fishbirdeyevisualslam_torch/ops/cuda_fast.py``, under the kernel's name."""

from __future__ import annotations

from portbench.reference.ops import fast as fast_ops


def fast_detect_levels(levels, th_hi: float, th_lo: float):
    """``[fast.detect(img, th_hi, th_lo, with_raw=True) for img in levels]``."""
    return [fast_ops.detect(img, th_hi, th_lo, with_raw=True) for img in levels]
