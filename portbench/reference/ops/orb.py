# Frozen copy of fishbirdeyevisualslam_torch/ops/orb.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
"""ORB orientation (intensity centroid) and rBRIEF descriptors over batches of
keypoint patches — the port of ``fishbirdeyevisualslam_tpu/ops/orb.py``
(reference ``IC_Angle`` / ``computeOrbDescriptor``, ``ORBextractor.cc:77,108``).

The pair pattern is the JAX package's own (a fixed-seed Gaussian BRIEF
pattern), rebuilt here in numpy so both packages produce the same bits.
Descriptors are kept packed — (N, 8) int32 holding the bits of the JAX
package's uint32 words, since torch's uint32 lacks most operations — and as
+/-1 bf16 (N, 256), the contraction operand of the matchers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.device import table

PATCH = 31
HALF = 15  # patch radius; patches are (31, 31) centred on the keypoint
N_BITS = 256
N_ANGLE_BINS = 32  # steering quantisation: 32 bins of 11.25 deg


@functools.lru_cache(maxsize=1)
def _circular_mask() -> np.ndarray:
    yy, xx = np.mgrid[-HALF: HALF + 1, -HALF: HALF + 1]
    return ((yy * yy + xx * xx) <= HALF * HALF).astype(np.float32)


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 4) int32 (y1, x1, y2, x2) sample-pair offsets: Gaussian pairs
    (sigma = PATCH/5), fixed seed, clipped to radius 13 so every rotation
    stays inside the patch circle."""
    rng = np.random.RandomState(20240817)
    pts = []
    while len(pts) < 2 * N_BITS:
        p = rng.randn(2) * (PATCH / 5.0)
        if p[0] ** 2 + p[1] ** 2 <= 13.0**2:
            pts.append(p)
    pts = np.asarray(pts, dtype=np.float32)
    return np.concatenate([pts[0::2], pts[1::2]], axis=1)


@functools.lru_cache(maxsize=4)
def _binned_sample_tables(n_bins: int):
    """Per-bin rotated sample indices: two (n_bins, 256) int32 tables of flat
    31x31 patch indices, one per point of every BRIEF pair."""
    pat = brief_pattern()
    centers = np.arange(n_bins) * (2.0 * np.pi / n_bins)
    ca, sa = np.cos(centers), np.sin(centers)

    def rot_idx(y, x):
        ry = x[None, :] * sa[:, None] + y[None, :] * ca[:, None]
        rx = x[None, :] * ca[:, None] - y[None, :] * sa[:, None]
        iy = np.clip(np.round(ry).astype(np.int64) + HALF, 0, PATCH - 1)
        ix = np.clip(np.round(rx).astype(np.int64) + HALF, 0, PATCH - 1)
        return (iy * PATCH + ix).astype(np.int32)

    return rot_idx(pat[:, 0], pat[:, 1]), rot_idx(pat[:, 2], pat[:, 3])


def _sample_table(n_bins: int, which: int) -> np.ndarray:
    return _binned_sample_tables(n_bins)[which]


def _coords() -> np.ndarray:
    return np.arange(-HALF, HALF + 1, dtype=np.float32)


def orientations(patches):
    """(N, 31, 31) intensity patches -> (N,) angle in radians:
    atan2(m01, m10) over the circular mask, coordinates centred on the keypoint."""
    dev = patches.device
    mask = table(_circular_mask, (), torch.float32, dev)
    coords = table(_coords, (), torch.float32, dev)
    I = patches * mask[None]
    m10 = torch.sum(I * coords[None, None, :], dim=(1, 2))
    m01 = torch.sum(I * coords[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


def quantize_angle_bin(angles, n_bins: int = N_ANGLE_BINS):
    step = 2.0 * np.pi / n_bins
    return torch.remainder(torch.round(angles / step).to(torch.int32), n_bins)


def descriptors(blurred_patches, angles, n_bins: int = N_ANGLE_BINS):
    """rBRIEF by the gather sampler: rotate the pair pattern by the
    bin-quantised keypoint angle, sample the blurred patch at both points,
    bit = (v1 < v2).  Returns (N, 256) uint8 bits."""
    dev = blurred_patches.device
    i1 = table(_sample_table, (n_bins, 0), torch.int64, dev)
    i2 = table(_sample_table, (n_bins, 1), torch.int64, dev)
    bin_id = quantize_angle_bin(angles, n_bins).long()
    flat = blurred_patches.reshape(blurred_patches.shape[0], -1)
    v1 = torch.gather(flat, 1, i1[bin_id])
    v2 = torch.gather(flat, 1, i2[bin_id])
    return (v1 < v2).to(torch.uint8)


def _bit_weights() -> np.ndarray:
    return (1 << np.arange(32)).astype(np.int64)


def pack_bits(bits):
    """(N, 256) {0,1} -> (N, 8) int32 words with the bits of the JAX package's
    uint32 words (bit k of word j = bit 32 j + k)."""
    w = table(_bit_weights, (), torch.int64, bits.device)
    words = torch.sum(bits.reshape(bits.shape[0], 8, 32).to(torch.int64) * w, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed):
    """(N, 8) int32 words -> (N, 256) {0,1} uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], N_BITS).to(torch.uint8)


def bits_to_pm1(bits, dtype=torch.bfloat16):
    """{0,1} bits -> +/-1 contraction operand: with a, b the +/-1 vectors,
    hamming = (256 - a.b) / 2."""
    return (bits.to(torch.float32) * 2.0 - 1.0).to(dtype)


def hamming_matrix(pm1_a, pm1_b):
    """(N1, 256) x (N2, 256) +/-1 -> (N1, N2) f32 Hamming distances.  The
    product runs in f32, which is exact for +/-1 (and all-zero) rows."""
    dot = pm1_a.to(torch.float32) @ pm1_b.to(torch.float32).T
    return 0.5 * (N_BITS - dot)
