"""The packed Hamming popcount of ``fishbirdeyevisualslam_torch/ops/cuda_matcher.py``
in plain PyTorch (local mapping's fusion reads it); the matching kernels'
plain versions are ``matcher.match`` over a dense compatibility mask, which
the reference's tracking calls directly."""

from __future__ import annotations

import torch

from portbench.reference.device import const

_POPCOUNT8 = tuple(bin(i).count("1") for i in range(256))


def popcount32(x):
    """Set bits of each int32 element, by a 256-entry byte table."""
    table = const(_POPCOUNT8, torch.int32, x.device)
    x = x.contiguous()
    return table[x.view(torch.uint8).long()].view(x.shape + (4,)).sum(-1, dtype=torch.int32)
