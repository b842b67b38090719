"""Closed-form 3D-3D alignment — the part of
``fishbirdeyevisualslam_tpu/solvers/sim3_solver.py`` that two-view
initialization needs: ``horn_alignment`` at a fixed scale, the bird-seeded
bootstrap's pose.
"""

from __future__ import annotations

import torch

from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.solvers import linalg


def horn_alignment(p1, p2, w):
    """The rigid motion T with p1 ~ T p2 over matched 3D sets (N, 3) weighted
    by ``w`` (N,), as a (7,) pose: Horn 1987 through the SVD of the weighted
    covariance (``Sim3Solver::ComputeSim3`` with the scale fixed at 1)."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    c1 = torch.sum(p1 * w[:, None], dim=0) / wsum
    c2 = torch.sum(p2 * w[:, None], dim=0) / wsum
    H = torch.einsum("n,ni,nj->ij", w, p2 - c2, p1 - c1)  # maps 2 -> 1
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(linalg.det3(Vt.T @ U.T))
    R = Vt.T @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ U.T
    return se3.make(se3.matrix_to_quat(R), c1 - R @ c2)
