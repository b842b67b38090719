"""Two-view monocular initialization with odometry metric scale — the port of
``fishbirdeyevisualslam_tpu/solvers/initializer.py`` (the reference's
``Initializer``, ``src/Initializer.cc``).

Batched fixed-iteration RANSAC and closed-form reconstruction:

  * the normalized 8-point fundamental matrix over a batch of hypotheses (one
    batched QR + SVD null-vector solve), scored by the symmetric epipolar chi2
    (``CheckFundamental``), then refit twice on all inliers;
  * the 8-point DLT homography over its own batch, scored by the symmetric
    transfer error (``CheckHomography``);
  * the 4 (R, t) hypotheses of E = K^T F K and the 8 Faugeras hypotheses of H,
    the translation scaled by the odometry (``ReconstructF``,
    ``Initializer.cc:567-585``), chosen by a triangulation census
    (``CheckRT``); H wins when SH / (SH + SF) > 0.40;
  * re-initialization with the rotation taken from the odometry
    (``ReInitconstructF``).

The hypotheses' samples are drawn by Gumbel-top-k, as in the JAX package: the
Gumbel noise of each RANSAC (iterations x points) is an input, drawn on the
host from a ``torch.Generator`` (``GumbelDraws``), so that the card and the
CPU, and the port and the JAX package, can be handed the same draws.  Equal
keys go to the lower index, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fishbirdeyevisualslam_torch.config import CameraConfig
from fishbirdeyevisualslam_torch.device import const, pick
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.solvers import linalg
from fishbirdeyevisualslam_torch.solvers.triangulate import triangulate


class InitResult(NamedTuple):
    success: torch.Tensor       # () bool
    T21: torch.Tensor           # (7,) camera-2-from-camera-1 pose
    Xw: torch.Tensor            # (N, 3) triangulated points in frame-1 camera coords
    triangulated: torch.Tensor  # (N,) bool
    n_good: torch.Tensor        # () int32
    used_h: torch.Tensor        # () bool, the homography's hypotheses won


class GumbelDraws:
    """The RANSAC hypotheses' Gumbel noise, from one CPU ``torch.Generator``
    seeded with ``seed``.  ``draws(n, n_iters, n_points)`` gives ``n`` tensors
    (n_iters, n_points) on the CPU: ``initialize`` takes two (F, then H),
    ``reinitialize`` one.  Drawn on the host so that every device samples the
    same hypotheses."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def __getstate__(self):   # a Generator does not pickle; its state does
        return {"state": self.generator.get_state()}

    def __setstate__(self, d):
        self.generator = torch.Generator()
        self.generator.set_state(d["state"])

    def __call__(self, n: int, n_iters: int, n_points: int):
        tiny = torch.finfo(torch.float32).tiny
        out = []
        for _ in range(n):
            u = torch.rand((n_iters, n_points), generator=self.generator).clamp_(min=tiny)
            out.append(-torch.log(-torch.log(u)))
        return tuple(out)


def _K(cam: CameraConfig, device):
    return const(((cam.fx, 0.0, cam.cx), (0.0, cam.fy, cam.cy), (0.0, 0.0, 1.0)),
                 torch.float32, device)


def _rows_topk(g, k: int):
    """Indices of the k largest entries of each row, equal values in index order."""
    return torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :k]


def _samples(valid, gumbel, k: int = 8):
    """(n_iters, k) distinct sample indices per hypothesis, valid points first."""
    logits = torch.where(valid, 0.0, -1e9)
    return _rows_topk(gumbel.to(valid.device) + logits[None, :], k)


def _normalize(uv, valid):
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    meandev = torch.sum(torch.abs(uv - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(meandev, min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (uv - mean) * s, T


def _square(A):
    """``A`` (..., N, M) with N < M padded with zero rows to (..., M, M): the
    same null space, and a square SVD runs batched on the card."""
    pad = A.shape[-1] - A.shape[-2]
    if pad <= 0:
        return A
    return torch.cat([A, A.new_zeros(A.shape[:-2] + (pad, A.shape[-1]))], dim=-2)


def _rank2(F):
    U, s, Vh = torch.linalg.svd(F)
    s = s * const((1.0, 1.0, 0.0), F.dtype, F.device)
    return (U * s[..., None, :]) @ Vh


def _design_F(uv1n, uv2n):
    u1, v1 = uv1n[..., 0], uv1n[..., 1]
    u2, v2 = uv2n[..., 0], uv2n[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _eight_point(uv1n, uv2n):
    """F from 8 normalized correspondences (..., 8, 2): the null vector of the
    design matrix (QR + SVD, ``solvers/linalg.py``), then rank 2."""
    A = _design_F(uv1n, uv2n)
    F = linalg.nullvec(_square(A)).reshape(A.shape[:-2] + (3, 3))
    return _rank2(F)


def _unit_corner(M):
    """``M`` scaled so that its (2, 2) entry is 1 (left as it is when that is ~0)."""
    m22 = M[..., 2:3, 2:3]
    return M / torch.where(torch.abs(m22) < 1e-12, 1.0, m22)


def _homogeneous(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _score_F(F, uv1, uv2, valid, sigma: float = 1.0):
    """Symmetric epipolar chi2 score (``CheckFundamental``) of F (..., 3, 3)."""
    th, th_score = 3.841, 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    p1, p2 = _homogeneous(uv1), _homogeneous(uv2)
    Fp1 = p1 @ F.mT   # epipolar lines in image 2
    Ftp2 = p2 @ F     # epipolar lines in image 1
    num = torch.sum(p2 * Fp1, dim=-1)
    d2_2 = num * num / torch.clamp(Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2, min=1e-12) * inv_s2
    d2_1 = num * num / torch.clamp(Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2, min=1e-12) * inv_s2
    in1 = (d2_1 < th) & valid
    in2 = (d2_2 < th) & valid
    score = (torch.sum(torch.where(in1, th_score - d2_1, 0.0), dim=-1)
             + torch.sum(torch.where(in2, th_score - d2_2, 0.0), dim=-1))
    return score, in1 & in2


def ransac_fundamental(uv1, uv2, valid, gumbel, sigma: float = 1.0):
    """Fixed-batch RANSAC: one hypothesis per row of ``gumbel`` (n_iters, N),
    all estimated and scored at once, then two all-inlier refits, each kept
    when it scores better.  Returns (F, score, inliers)."""
    idx = _samples(valid, gumbel)
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    Fs = _unit_corner(T2.T @ _eight_point(uv1n[idx], uv2n[idx]) @ T1)
    scores, _ = _score_F(Fs, uv1, uv2, valid, sigma)
    F = pick(Fs, torch.argmax(scores))
    score, inliers = _score_F(F, uv1, uv2, valid, sigma)
    A_all = _design_F(uv1n, uv2n)
    for _ in range(2):
        A = A_all * inliers.to(uv1.dtype)[:, None]
        Fr = _unit_corner(T2.T @ _rank2(linalg.nullvec(A).reshape(3, 3)) @ T1)
        score_r, inl_r = _score_F(Fr, uv1, uv2, valid, sigma)
        better = score_r > score
        F = torch.where(better, Fr, F)
        score = torch.where(better, score_r, score)
        inliers = torch.where(better, inl_r, inliers)
    return F, score, inliers


def _dlt_homography(uv1n, uv2n):
    """H from normalized correspondences (..., 8, 2): the null vector of the
    DLT system (``ComputeH21``, ``Initializer.cc:377-416``)."""
    u1, v1 = uv1n[..., 0], uv1n[..., 1]
    u2, v2 = uv2n[..., 0], uv2n[..., 1]
    zero, one = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    return linalg.nullvec(_square(A)).reshape(A.shape[:-2] + (3, 3))


def _score_H(H, uv1, uv2, valid, sigma: float = 1.0):
    """Symmetric transfer error score (``CheckHomography``) of H (..., 3, 3)."""
    th = 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    p1, p2 = _homogeneous(uv1), _homogeneous(uv2)

    def dehom(q):
        return q[..., :2] / torch.where(torch.abs(q[..., 2:]) < 1e-12, 1e-12, q[..., 2:])

    q2 = dehom(p1 @ H.mT)
    q1 = dehom(p2 @ linalg.inv3(H).mT)
    d2_2 = torch.sum((uv2 - q2) ** 2, dim=-1) * inv_s2
    d2_1 = torch.sum((uv1 - q1) ** 2, dim=-1) * inv_s2
    in1 = (d2_1 < th) & valid
    in2 = (d2_2 < th) & valid
    score = (torch.sum(torch.where(in1, th - d2_1, 0.0), dim=-1)
             + torch.sum(torch.where(in2, th - d2_2, 0.0), dim=-1))
    return score, in1 & in2


def ransac_homography(uv1, uv2, valid, gumbel, sigma: float = 1.0):
    """Fixed-batch RANSAC over 8-point samples, one per row of ``gumbel``.
    Returns (H, score, inliers)."""
    idx = _samples(valid, gumbel)
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    Hs = _unit_corner(linalg.inv3(T2) @ _dlt_homography(uv1n[idx], uv2n[idx]) @ T1)
    scores, _ = _score_H(Hs, uv1, uv2, valid, sigma)
    H = pick(Hs, torch.argmax(scores))
    score, inliers = _score_H(H, uv1, uv2, valid, sigma)
    return H, score, inliers


def decompose_H(H, K):
    """Faugeras-Lustman decomposition of a calibrated homography into 8 motion
    hypotheses (``ReconstructH``, ``Initializer.cc:418-565``).  Returns (Rs
    (8, 3, 3), unit ts (8, 3), degenerate) — degenerate when two singular
    values are too close (pure rotation, plane at infinity)."""
    dev, dt = H.device, H.dtype
    A = linalg.inv3(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = linalg.det3(U) * linalg.det3(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    degenerate = (d1 / d2 < 1.00001) | (d2 / d3 < 1.00001)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    x1s = const((1.0, 1.0, -1.0, -1.0), dt, dev) * aux1
    x3s = const((1.0, -1.0, 1.0, -1.0), dt, dev) * aux3
    signs = const((1.0, -1.0, -1.0, 1.0), dt, dev)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)
    # case d' = d2
    ctheta = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand(4)
    sths = signs * root / ((d1 + d3) * d2)
    Rp1 = torch.stack([torch.stack([ctheta, zero, -sths], -1), torch.stack([zero, one, zero], -1),
                       torch.stack([sths, zero, ctheta], -1)], -2)
    tp1 = torch.stack([x1s, 0.0 * x1s, -x3s], -1) * (d1 - d3)
    # case d' = -d2
    den = torch.where(torch.abs(d1 - d3) < 1e-12, 1e-12, d1 - d3)
    cphi = ((d1 * d3 - d2 * d2) / (den * d2)).expand(4)
    sphs = signs * root / (den * d2)
    Rp2 = torch.stack([torch.stack([cphi, zero, sphs], -1), torch.stack([zero, -one, zero], -1),
                       torch.stack([sphs, zero, -cphi], -1)], -2)
    tp2 = torch.stack([x1s, 0.0 * x1s, x3s], -1) * (d1 + d3)
    Rs = s * (U @ torch.cat([Rp1, Rp2]) @ Vt)
    ts = torch.cat([tp1, tp2]) @ U.T
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts, degenerate


def decompose_E(E):
    """The two rotations and the unit translation of an essential matrix
    (``DecomposeE``): 4 motion hypotheses (R1 | R2, +t | -t)."""
    U, _, Vt = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    W = const(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    return R1 * torch.sign(linalg.det3(R1)), R2 * torch.sign(linalg.det3(R2)), t


def _census(cam: CameraConfig, R, t, uv1, uv2, valid, sigma2: float):
    """``CheckRT``: triangulate under each hypothesis (R (H, 3, 3), t (H, 3))
    and count the acceptable points.  Returns (n_good (H,) int32, mask (H, N),
    the triangulation): the count includes low-parallax points, the mask
    requires parallax."""
    Tcw2 = se3.make(se3.matrix_to_quat(R), t)[:, None, :]
    tri = triangulate(cam, se3.identity(device=R.device), Tcw2, uv1, uv2,
                      max_reproj_err=4.0 * sigma2, min_parallax_cos=0.99998)
    n_good = torch.sum((tri.geom_ok & valid).to(torch.int32), dim=-1)
    return n_good, tri.valid & valid, tri


def _unique_best(counts, n_inliers, min_triangulated: int):
    """CheckRT's acceptance of the best hypothesis: at least 0.9 of the inliers
    (and ``min_triangulated``) and no runner-up above 0.7 of it."""
    best = torch.max(counts)
    n_similar = torch.sum((counts > 0.7 * best).to(torch.int32))
    n_min = torch.clamp((0.9 * n_inliers).to(torch.int32), min=min_triangulated)
    return (best >= n_min) & (n_similar == 1), best


def _T(R, t):
    return se3.make(se3.matrix_to_quat(R), t)


def initialize(cam: CameraConfig, uv1, uv2, valid, T21_odom, gumbel, loose_couple: bool = True,
               sigma: float = 1.0, min_triangulated: int = 50) -> InitResult:
    """Two-view initialization with H/F model selection.  ``T21_odom``: the
    camera-2-from-camera-1 pose from odometry (the metric scale);
    ``uv*``: undistorted pixels, frame 1 the gauge; ``gumbel``: the F and
    the H RANSAC's noise, (n_iters, N) each."""
    dev = uv1.device
    K = _K(cam, dev)
    gF, gH = gumbel
    F, score_f, inliers_f = ransac_fundamental(uv1, uv2, valid, gF, sigma)
    H, score_h, inliers_h = ransac_homography(uv1, uv2, valid, gH, sigma)
    t_odom = T21_odom[4:]

    # F: 4 hypotheses from E, the translation at the odometry's scale
    R1, R2, t = decompose_E(K.T @ F @ K)
    if loose_couple:
        t = t * torch.dot(t_odom, t)
    Rf = torch.stack([R1, R2, R1, R2])
    tf = torch.stack([t, t, -t, -t])
    # H: 8 Faugeras hypotheses, each scaled by the odometry; scaling by the
    # signed dot folds each +/-t pair onto one pose, so the mirrored one
    # (negative dot) is dropped
    Rh, th, degen_h = decompose_H(H, K)
    s_h = th @ t_odom
    if loose_couple:
        th = th * s_h[:, None]
        hyp_ok_h = s_h > 1e-6
    else:
        hyp_ok_h = torch.ones(8, dtype=torch.bool, device=dev)

    valid_all = torch.cat([inliers_f.expand(4, -1), inliers_h.expand(8, -1)])
    counts, masks, tri = _census(cam, torch.cat([Rf, Rh]), torch.cat([tf, th]), uv1, uv2,
                                 valid_all, sigma * sigma)
    counts_f = counts[:4]
    ok_f, max_f = _unique_best(counts_f, torch.sum(inliers_f.to(torch.int32)), min_triangulated)
    best_f = torch.argmax(counts_f)

    # uniqueness of H on parallax-qualified counts
    counts_h = torch.where(hyp_ok_h, counts[4:], -1)
    n_par_h = torch.where(hyp_ok_h, torch.sum(masks[4:].to(torch.int32), dim=1), -1)
    top2 = torch.sort(n_par_h, descending=True).values[:2]
    n_min_h = torch.clamp((0.9 * torch.sum(inliers_h.to(torch.int32))).to(torch.int32),
                          min=min_triangulated)
    best_h = torch.argmax(n_par_h)
    ok_h = (counts_h[best_h] >= n_min_h) & (top2[1] < 0.75 * torch.clamp(top2[0], min=1)) \
        & ~degen_h

    # model selection: RH = SH / (SH + SF) > 0.40 (Initialize, :124-134)
    use_h = score_h / torch.clamp(score_h + score_f, min=1e-9) > 0.40
    best = torch.where(use_h, 4 + best_h, best_f)
    T21s = _T(torch.cat([Rf, Rh]), torch.cat([tf, th]))
    ok = torch.where(use_h, ok_h, ok_f)
    return InitResult(ok, pick(T21s, best), pick(tri.Xw, best), pick(masks, best) & ok,
                      torch.where(use_h, counts_h[best_h], max_f), use_h)


def reinitialize(cam: CameraConfig, uv1, uv2, valid, T21_odom, gumbel, sigma: float = 1.0,
                 min_triangulated: int = 50) -> InitResult:
    """Loss recovery (``ReInitialize`` / ``ReInitconstructF``): F only gates
    the inliers; the rotation comes from the odometry, and only the +/- scaled
    translation direction of E is tested.  ``gumbel``: (n_iters, N)."""
    K = _K(cam, uv1.device)
    F, _, inliers = ransac_fundamental(uv1, uv2, valid, gumbel, sigma)
    _, _, t = decompose_E(K.T @ F @ K)
    R3 = se3.quat_to_matrix(T21_odom[:4])
    t = t * torch.dot(T21_odom[4:], t)
    Rs, ts = torch.stack([R3, R3]), torch.stack([t, -t])
    counts, masks, tri = _census(cam, Rs, ts, uv1, uv2, inliers.expand(2, -1), sigma * sigma)
    ok, max_good = _unique_best(counts, torch.sum(inliers.to(torch.int32)), min_triangulated)
    best = torch.argmax(counts)
    return InitResult(ok, pick(_T(Rs, ts), best), pick(tri.Xw, best), pick(masks, best) & ok,
                      max_good, torch.zeros((), dtype=torch.bool, device=uv1.device))
