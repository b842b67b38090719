# Frozen copy of fishbirdeyevisualslam_torch/solvers/linalg.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Small dense linear algebra for the solvers — the port of
``fishbirdeyevisualslam_tpu/solvers/linalg.py``.

Null vectors come from a QR of the design matrix followed by an SVD of its
small triangular factor, which keeps the condition number of A; the route
through ``eigh(A^T A)`` squares it and loses the null vector in f32
(``tests/test_linalg.py``).  The 3x3 inverse is closed form.
"""

from __future__ import annotations

import torch


def householder_r(A):
    """The R factor (..., min(N, M), M) of the QR factorisation of ``A``
    (..., N, M), by Householder reflections applied to the whole batch at
    once, up to the signs of its rows.  ``torch.linalg.qr`` on the card
    factors a batch of small matrices one matrix at a time (~2048 x 6
    kernel launches for one triangulation); this is ~10 batched ops per
    column."""
    N, M = A.shape[-2:]
    R = A
    for k in range(min(N - 1, M)):
        x = R[..., k:, k]
        norm = torch.linalg.vector_norm(x, dim=-1)
        alpha = torch.where(x[..., 0] < 0, norm, -norm)
        v = x - alpha[..., None] * (torch.arange(N - k, device=A.device) == 0)
        vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = torch.where(vn > 0, v / torch.where(vn > 0, vn, 1.0), 0.0)
        below = R[..., k:, :] - 2.0 * v[..., :, None] * (v[..., None, :] @ R[..., k:, :])
        R = torch.cat([R[..., :k, :], below], dim=-2)
    return torch.triu(R[..., :min(N, M), :])


def smallest_right_singular_vectors(A, k: int = 1):
    """(..., k, M) right singular vectors of ``A`` (..., N, M) for its k
    smallest singular values, smallest first.  The signs of R's rows leave
    the right singular vectors as they are."""
    _, _, Vh = torch.linalg.svd(householder_r(A))
    return Vh.flip(-2)[..., :k, :]


def nullvec(A):
    """(..., M) right singular vector of ``A`` for its smallest singular value."""
    return smallest_right_singular_vectors(A, 1)[..., 0, :]


def inv3(A):
    """Batched 3x3 inverse by adjugate over determinant (|det| floored at 1e-18)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def solve3(A, b):
    """Batched 3x3 solve through ``inv3``."""
    return torch.einsum("...ij,...j->...i", inv3(A), b)


