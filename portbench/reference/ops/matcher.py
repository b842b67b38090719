# Frozen copy of fishbirdeyevisualslam_torch/ops/matcher.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Batched descriptor matching — the port of
``fishbirdeyevisualslam_tpu/ops/matcher.py`` (the reference's ORBmatcher,
``src/ORBmatcher.cc``) as dense masked problems: all-pairs Hamming distances
from one +/-1 contraction, a compatibility mask, best and second-best per row,
and the rotation-consistency histogram (``ComputeThreeMaxima``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from portbench.reference.ops import orb as orb_ops

BIG = 1e9


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (N1,) int32 index into B, -1 if unmatched
    dist: torch.Tensor  # (N1,) float32 Hamming distance (BIG if unmatched)
    ok: torch.Tensor    # (N1,) bool

    @property
    def count(self):
        return torch.sum(self.ok.to(torch.int32))


def window_mask(xy_a, xy_b, radius):
    """(N1, N2) bool: b within a square window around a; ``radius`` a number
    or an (N1,) per-query tensor."""
    d = torch.abs(xy_a[:, None, :] - xy_b[None, :, :])
    r = radius
    if isinstance(r, torch.Tensor) and r.dim() == 1:
        r = r[:, None]
    return (d[..., 0] <= r) & (d[..., 1] <= r)


def match(pm1_a, pm1_b, compat, max_dist: float,
          ratio: Optional[float] = None) -> MatchResult:
    """Best match of each A row in B under a compatibility mask.

    The best is the least distance, ties going to the LOWEST column; the
    second-best is the least distance over every other compatible column (it
    may equal the best) — the JAX package's packed-min semantics.  ``ratio``:
    best < ratio * second."""
    D = orb_ops.hamming_matrix(pm1_a, pm1_b)
    D = torch.where(compat, D, BIG)
    best, bidx = torch.min(D, dim=1)  # first occurrence of the minimum
    col = torch.arange(D.shape[1], device=D.device)
    second = torch.where(col[None, :] == bidx[:, None], BIG, D).min(dim=1).values
    bidx = bidx.to(torch.int32)
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best < ratio * second)
    return MatchResult(torch.where(ok, bidx, -1), torch.where(ok, best, BIG), ok)


def resolve_duplicates(res: MatchResult, n_b: int) -> MatchResult:
    """One-to-one: where several A rows matched one B column keep the closest,
    equal distances going to the lowest row."""
    dev = res.idx.device
    n_a = res.idx.shape[0]
    tgt = torch.where(res.ok, res.idx, n_b - 1).long()
    per_col = torch.full((n_b,), BIG, dtype=torch.float32, device=dev).scatter_reduce(
        0, tgt, torch.where(res.ok, res.dist, BIG), "amin")
    safe = res.idx.clamp(0, n_b - 1).long()
    is_best = res.ok & (res.dist <= per_col[safe])
    rows = torch.arange(n_a, dtype=torch.int64, device=dev)
    first_row = torch.full((n_b,), n_a, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(is_best, res.idx, n_b - 1).long(),
        torch.where(is_best, rows, n_a), "amin")
    ok = is_best & (first_row[safe] == rows)
    return MatchResult(torch.where(ok, res.idx, -1), torch.where(ok, res.dist, BIG), ok)
