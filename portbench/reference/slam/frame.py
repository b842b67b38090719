# Frozen copy of fishbirdeyevisualslam_torch/slam/frame.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Per-frame perception: dual-view feature extraction + geometry — the port of
``fishbirdeyevisualslam_tpu/slam/frame.py`` (the dual-view ``Frame``
constructor, ``src/Frame.cc:262-379``): front ORB + fisheye undistortion,
bird ORB on the freespace (and contour) mask, and the metric lift of every
bird keypoint to the vehicle base plane and the front camera frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from portbench.reference.config import SystemConfig
from portbench.reference.device import const, resolve_device
from portbench.reference.geometry import camera as cam_ops
from portbench.reference.geometry import ipm
from portbench.reference.ops import features, orb


class Frame(NamedTuple):
    # front view
    uv_raw: torch.Tensor         # (F, 2) distorted pixel coords
    uv: torch.Tensor             # (F, 2) undistorted
    octave: torch.Tensor         # (F,) int32
    angle: torch.Tensor          # (F,)
    desc: torch.Tensor           # (F, 8) int32 (uint32 bits)
    desc_pm1: torch.Tensor       # (F, 256) bf16
    kp_valid: torch.Tensor       # (F,) bool
    # bird view
    bird_uv: torch.Tensor        # (FB, 2) bird-image pixels
    bird_octave: torch.Tensor    # (FB,) int32
    bird_desc: torch.Tensor      # (FB, 8) int32
    bird_desc_pm1: torch.Tensor  # (FB, 256) bf16
    bird_kp_valid: torch.Tensor  # (FB,) bool
    bird_base: torch.Tensor      # (FB, 3) vehicle-base ground points (z=0)
    bird_cam: torch.Tensor       # (FB, 3) camera-frame metric points
    # odometry + bookkeeping
    odom: torch.Tensor           # (3,)
    timestamp: torch.Tensor      # ()


def bird_detection_mask(freespace_mask, contour, dilate: int = 3):
    """Keypoints stay on freespace AND near labelled contour edges (label < 150,
    ``Frame.cc:690-707``); the per-keypoint ``nearEdges`` search becomes a
    max-pool dilation of the edge map."""
    edge = (contour < 150.0) & (freespace_mask > 0)
    k = 2 * dilate + 1
    near = F.max_pool2d(edge.to(torch.float32)[None, None], k, stride=1, padding=dilate)[0, 0]
    return (freespace_mask > 0) & (near > 0)


def _as_tensor(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    if isinstance(x, (int, float)):  # filled on the device: no host-to-device copy
        return torch.full((), x, dtype=dtype, device=dev)
    return torch.as_tensor(x, dtype=dtype).to(dev)


def build_frame(front_gray, bird_gray, bird_mask, odom, timestamp, cfg: SystemConfig,
                n_features: int, contour=None, n_bird_features: int = 0,
                device=None) -> Frame:
    """One frame from its two grayscale views (H, W) and freespace mask.

    Inputs may be numpy arrays or tensors; everything runs on ``device`` (the
    current CUDA card by default)."""
    dev = resolve_device(device)
    f32 = torch.float32
    front_gray = _as_tensor(front_gray, f32, dev)
    bird_gray = _as_tensor(bird_gray, f32, dev)
    bird_mask = _as_tensor(bird_mask, f32, dev)
    det_mask = bird_mask > 0
    if contour is not None:
        det_mask = bird_detection_mask(bird_mask, _as_tensor(contour, f32, dev))
    kp, bkp = features.extract_dual(
        front_gray, bird_gray, cfg.orb, n_features, n_bird_features or n_features,
        mask_b=det_mask)
    uv_und = cam_ops.undistort_fisheye(cfg.camera, kp.xy)
    uv_und = torch.where(kp.valid[:, None], uv_und, torch.zeros_like(uv_und))
    base = ipm.bird_pixel_to_base_xy(cfg.bird, bkp.xy)
    cam = ipm.base_xyz_to_cam(cfg.extrinsics, base)
    return Frame(
        uv_raw=kp.xy, uv=uv_und, octave=kp.level, angle=kp.angle, desc=kp.desc,
        desc_pm1=kp.desc_pm1, kp_valid=kp.valid,
        bird_uv=bkp.xy, bird_octave=bkp.level, bird_desc=bkp.desc,
        bird_desc_pm1=bkp.desc_pm1, bird_kp_valid=bkp.valid,
        bird_base=base, bird_cam=cam,
        odom=_as_tensor(odom, f32, dev).reshape(3),
        timestamp=_as_tensor(timestamp, f32, dev).reshape(()),
    )


def inv_level_sigma2_lut(cfg: SystemConfig, device=None):
    return const(cfg.orb.inv_level_sigma2(), torch.float32, device)


def desc_pm1_from_packed(packed):
    """(N, 8) int32 packed words -> (N, 256) bf16 contraction operand."""
    return orb.bits_to_pm1(orb.unpack_bits(packed))
