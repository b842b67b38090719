"""Per-launch operations and bytes of the port's kernels, and the card's
peaks: a frozen copy of the arithmetic of ``chip_smoke.py`` (``bound``,
``window_pixels`` and the counts of ``phase_kernels`` and
``phase_pose_and_hamming``), so that a change to the port cannot change what
its kernels are held to.

Each count takes what the launch's inputs need: every input byte read once
and every output byte written once, and the operations of the algorithm at
these shapes.  The least time of a launch is the larger of its operations
over the peak rate of the unit it runs on and its bytes over the memory
bandwidth.
"""

from __future__ import annotations

import torch

# H100 SXM data-sheet peaks (dense, 700 W): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAKS = {"bf16_flops": PEAK_BF16, "f32_flops": PEAK_F32, "hbm_bytes_per_s": PEAK_BYTES}


def least_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """The least time of a launch, in seconds."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)


def fast_counts(levels) -> tuple:
    """FAST + NMS over every pyramid level (kernel 1): 12 bytes and 96
    operations a pixel (16 circle tests for 6 passes)."""
    px = sum(int(l.numel()) for l in levels)
    return px * 12, px * 16 * 6, PEAK_F32


def window_pixels(atlas, yx, side: int) -> int:
    """Distinct atlas pixels that the gather's windows cover, with the corners
    clamped as the gather clamps them: what it must read at least."""
    h, w = atlas.shape
    y, x = yx[:, 0].long(), yx[:, 1].long()
    y = torch.where(y < 0, y + h, y).clamp(0, h - side)
    x = torch.where(x < 0, x + w, x).clamp(0, w - side)
    ar = torch.arange(side, device=atlas.device)
    idx = ((y[:, None] + ar)[:, :, None] * w + (x[:, None] + ar)[:, None, :]).reshape(-1)
    hit = torch.zeros(h * w, dtype=torch.bool, device=atlas.device)
    hit[idx] = True
    return int(hit.sum())


def patch_counts(atlas, yx, side: int) -> tuple:
    """Patch gather (kernel 2): the distinct pixels read, the corners, the
    patches written; no arithmetic."""
    n = int(yx.shape[0])
    read_px = window_pixels(atlas, yx, side)
    return read_px * 4 + yx.numel() * 4 + n * side * side * 4, 0, PEAK_F32


def projection_match_counts(na: int, nb: int) -> tuple:
    """Projection matchers (kernels 3 and 4): one +/-1 bf16 contraction of
    every query with every target (2 * 256 flops a pair); the descriptors,
    positions, octaves, radii and flags read, the results written."""
    flops = 2.0 * na * nb * 256
    nbytes = (na + nb) * 512 + na * 16 + nb * 20 + na * 9 * 2
    return nbytes, flops, PEAK_BF16


def pose_opt_counts(n_front: int, n_bird: int, n_active_front: int, n_active_bird: int,
                    rounds: int, iters: int) -> tuple:
    """Pose optimisation (kernel 5): per active observation and evaluation a
    transform, residual, Jacobian and 21 + 6 weighted sums (~200 flops), per
    re-gate ~35 flops per observation; the observations read once."""
    evals = rounds * (iters + 1)
    ops = evals * (n_active_front + n_active_bird) * 200 + rounds * (n_front + n_bird) * 35
    nbytes = n_front * (6 * 4 + 1 + 1) + n_bird * (7 * 4 + 1 + 1) + 7 * 4 * 3
    return nbytes, ops, PEAK_F32


def hamming_counts(na: int, nb: int) -> tuple:
    """Packed Hamming matrix (kernel 6): XOR + popcount + add on 8 words a pair."""
    return (na + nb) * 32 + na * nb * 4, na * nb * 8 * 3, PEAK_F32
