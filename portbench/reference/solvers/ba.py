# Frozen copy of fishbirdeyevisualslam_torch/solvers/ba.py (imports renamed to portbench.reference):
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Sparse Levenberg-Marquardt bundle adjustment with a Schur complement — the
port of ``fishbirdeyevisualslam_tpu/solvers/ba.py`` (the reference's
``LocalBundleAdjustmentWithOdom``, ``src/Optimizer.cc:2137-2495``): camera
poses, front reprojection edges, bird 3D-3D edges and SE3 odometry edges,
with two LM stages around an outlier re-gate.

Observations are grouped by landmark into fixed-width blocks (P, M), so
marginalising the points is a batched 3x3 inverse.  The reduced camera system
is held as (K, 6, K, 6), which reshapes to the dense (6K, 6K) matrix without
a copy, and is assembled by one-hot contractions in f32: a matmul sums in a
fixed order, so the system is the same bit for bit from run to run on the
card, where a float ``index_add_`` sums in the order its atomics land.  The
reduced solve is a Cholesky; where it fails or gives a non-finite step, an
LU solve of the same system is taken instead, selected on the device (no host
read).

Given a ``torch.distributed`` process group, the landmark blocks are this
rank's shard of the problem (the counterpart of the JAX solver's
``axis_name`` under ``shard_map``): each LM step sums the shards' reduced
camera systems ``Hcc_f + Hcc_b``, their right-hand sides ``bc_f + bc_b`` and
the family chi2 with ``all_reduce`` over the group, then adds the odometry
terms, which every rank holds whole.  Poses, the reduced solve and the accept
decision are replicated, so every rank takes the same steps; the landmark
back-substitution stays on the shard (``parallel/sharded_ba.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from portbench.reference.config import BAConfig, CameraConfig
from portbench.reference.geometry import se3
from portbench.reference.solvers import residuals as res
from portbench.reference.solvers.linalg import inv3


class PointBlocks(NamedTuple):
    """Landmark-major observation blocks of one residual family: the
    measurement is uv (D=2) for front points, the camera-frame point (D=3)
    for bird points."""

    Xw: torch.Tensor           # (P, 3) landmark positions (optimised)
    kf_idx: torch.Tensor       # (P, M) int observing keyframe slot
    meas: torch.Tensor         # (P, M, D)
    inv_sigma2: torch.Tensor   # (P, M)
    valid: torch.Tensor        # (P, M) bool
    point_valid: torch.Tensor  # (P,) bool


class OdomEdges(NamedTuple):
    """SE3 relative-pose factors between keyframe slots."""

    i: torch.Tensor       # (E,) int
    j: torch.Tensor       # (E,) int
    T_meas: torch.Tensor  # (E, 7) measured T_i_j
    info: torch.Tensor    # (E,) isotropic information
    valid: torch.Tensor   # (E,) bool


class BAResult(NamedTuple):
    poses: torch.Tensor         # (K, 7)
    front_Xw: torch.Tensor      # (P, 3)
    bird_Xw: torch.Tensor       # (PB, 3)
    front_inlier: torch.Tensor  # (P, M) bool
    bird_inlier: torch.Tensor   # (PB, MB) bool


def _family_terms(cam, poses, blocks: PointBlocks, weight, huber_delta, use_huber: bool,
                  active, is_front: bool):
    """Residuals, Jacobians and IRLS weights of one family:
    e (P,M,D), Jc (P,M,D,6), Jp (P,M,D,3), w (P,M)."""
    T = poses[blocks.kf_idx.long()]
    X = blocks.Xw[:, None, :]
    if is_front:
        e, Jc, _ = res.front_residuals(cam, T, X, blocks.meas)
        Jp = res.front_point_jacobian(cam, T, X)
    else:
        e, Jc, _ = res.bird_residuals(T, X, blocks.meas)
        Jp = res.bird_point_jacobian(T, X)
    info = blocks.inv_sigma2 * weight
    chi2 = torch.sum(e * e, dim=-1) * info
    w = res.huber_weights(chi2, huber_delta) if use_huber else torch.ones_like(chi2)
    return e, Jc, Jp, w * info * active


def _family_chi2(cam, poses, blocks: PointBlocks, weight, is_front: bool):
    """Residual-only chi2 and the positive-depth mask: (chi2 (P,M), depth_ok (P,M))."""
    T = poses[blocks.kf_idx.long()]
    X = blocks.Xw[:, None, :]
    if is_front:
        e, p = res.front_error(cam, T, X, blocks.meas)
    else:
        e, p = res.bird_error(T, X, blocks.meas)
    return torch.sum(e * e, dim=-1) * (blocks.inv_sigma2 * weight), p[..., 2] > 0


def _odom_chi2(poses, edges: OdomEdges, w_scale):
    e = se3.relative_error(edges.T_meas, poses[edges.i.long()], poses[edges.j.long()])
    return torch.sum(e * e, dim=-1) * edges.info * edges.valid * w_scale


def _one_hot(idx, K: int, dtype):
    return (idx.long()[..., None] == torch.arange(K, device=idx.device)).to(dtype)


def _accumulate_family(K: int, e, Jc, Jp, w, kf_idx, lam_p):
    """One family's share of the reduced system: (Hcc (K,6,K,6), bc (K,6),
    Hpp^-1 (P,3,3), bp (P,3), Hcp (P,M,6,3)).  Solving H dx = b with
    b = -J^T W e (residual e = observed - predicted)."""
    P, M = w.shape
    Hc_diag = torch.einsum("pmdi,pm,pmdj->pmij", Jc, w, Jc)
    bc_obs = -torch.einsum("pmdi,pm,pmd->pmi", Jc, w, e)
    Hpp = torch.einsum("pmdi,pm,pmdj->pij", Jp, w, Jp)
    bp = -torch.einsum("pmdi,pm,pmd->pi", Jp, w, e)
    Hcp = torch.einsum("pmdi,pm,pmdj->pmij", Jc, w, Jp)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    trace = Hpp.diagonal(dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + lam_p * eye3 * torch.clamp(trace / 3.0, min=1e-6)[..., None, None]
    Hpp_inv = inv3(Hpp_d + 1e-9 * eye3)
    Tm = torch.einsum("pmij,pjk->pmik", Hcp, Hpp_inv)          # (P,M,6,3)
    bs = torch.einsum("pmik,pk->pmi", Tm, bp)
    O = _one_hot(kf_idx, K, w.dtype)                           # (P,M,K)
    diag = torch.einsum("pmk,pmij->kij", O, Hc_diag)
    bc = torch.einsum("pmk,pmi->ki", O, bc_obs - bs)
    # pair[k, a, l, b] = sum over points and coordinates of U[., k, a, .] V[., l, b, .]
    U = torch.einsum("pmk,pmax->kapx", O, Tm).reshape(K * 6, P * 3)
    V = torch.einsum("pmk,pmax->kapx", O, Hcp).reshape(K * 6, P * 3)
    Hcc = -(U @ V.T).reshape(K, 6, K, 6) + _block_diag(diag)
    return Hcc, bc, Hpp_inv, bp, Hcp


def _block_diag(blocks):
    """(K, d, d) -> (K, d, K, d) with the blocks on the diagonal."""
    K = blocks.shape[0]
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("kl,kab->kalb", eye, blocks)


EDGE_CHUNK = 4096   # edges per matmul of the (i, j) blocks


def edge_blocks(K: int, i, j, Ji, Jj, r, w, chunks=None):
    """The normal equations of E binary edges over K vertices of d dof:
    H (K, d, K, d) = sum_e J_e^T w_e J_e and g (K, d) = sum_e J_e^T w_e r_e,
    where J_e = [Ji_e, Jj_e] are the (E, m, d) Jacobians of the residual
    r_e (E, m) against its vertices i_e and j_e, and w_e its weight (E,).
    The diagonal blocks by one-hot contractions; the (i, j) blocks as
    Oi^T (Oj x Hij), one matmul per chunk of edges, the chunks summed in
    order (a pose graph has K + K^2 + L edges, and a three-operand einsum may
    form the (E, K, K) product of the one-hots), so the sums run in a fixed
    order and the system is the same bit for bit from run to run.
    ``chunks``: the starts of the chunks to take (default all); a chunk left
    out must hold no edge of nonzero weight, and the system is then the
    same bit for bit."""
    d = Ji.shape[-1]
    Hii = torch.einsum("eki,e,ekj->eij", Ji, w, Ji)
    Hjj = torch.einsum("eki,e,ekj->eij", Jj, w, Jj)
    Hij = torch.einsum("eki,e,ekj->eij", Ji, w, Jj)
    gi = torch.einsum("eki,e,ek->ei", Ji, w, r)
    gj = torch.einsum("eki,e,ek->ei", Jj, w, r)
    Oi, Oj = _one_hot(i, K, w.dtype), _one_hot(j, K, w.dtype)
    diag = torch.einsum("ek,eab->kab", Oi, Hii) + torch.einsum("ek,eab->kab", Oj, Hjj)
    cross = Hij.new_zeros(K, K * d * d)
    for s in range(0, Oi.shape[0], EDGE_CHUNK) if chunks is None else chunks:
        Z = Oj[s:s + EDGE_CHUNK, :, None] * Hij[s:s + EDGE_CHUNK].reshape(-1, 1, d * d)
        cross = cross + Oi[s:s + EDGE_CHUNK].T @ Z.reshape(Z.shape[0], K * d * d)
    cross = cross.reshape(K, K, d, d).permute(0, 2, 1, 3)      # (k, a, l, b)
    H = cross + cross.permute(2, 3, 0, 1) + _block_diag(diag)
    g = torch.einsum("ek,ei->ki", Oi, gi) + torch.einsum("ek,ei->ki", Oj, gj)
    return H, g


def _odom_terms(K: int, poses, edges: OdomEdges, w_scale, chunks=None):
    e, J1, J2 = res.odom_residuals(edges.T_meas, poses[edges.i.long()],
                                   poses[edges.j.long()])
    Hcc, g = edge_blocks(K, edges.i, edges.j, J1, J2, e, edges.info * edges.valid * w_scale,
                         chunks)
    return Hcc, -g


def _solve_reduced(Hcc, bc, fixed, lam_c):
    """Damped reduced solve with the fixed poses pinned: a Cholesky solve, or
    an LU solve of the same system where the Cholesky fails or its step is
    not finite."""
    H, b = _reduced_system(Hcc, bc, fixed, lam_c)
    L, info = torch.linalg.cholesky_ex(H)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.all(torch.isfinite(dx))
    dx_lu = torch.linalg.solve_ex(H, b)[0]
    return torch.where(bad, dx_lu, dx).reshape(-1, 6)


def _reduced_system(Hcc, bc, fixed, lam_c):
    """The dense (6K, 6K) system: Levenberg damping on the diagonal blocks,
    identity rows and columns and a zero right-hand side for fixed poses."""
    K = Hcc.shape[0]
    diag = Hcc.diagonal(dim1=0, dim2=2).permute(2, 0, 1)        # (K, 6, 6)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    trace = diag.diagonal(dim1=-2, dim2=-1).sum(-1)
    damp = lam_c * eye6 * torch.clamp(trace / 6.0, min=1e-6)[:, None, None]
    H = (Hcc + _block_diag(damp)).reshape(6 * K, 6 * K)
    b = bc.reshape(6 * K)
    fmask = fixed.repeat_interleave(6)
    H = torch.where(fmask[:, None] | fmask[None, :], 0.0, H)
    H = H + torch.diag(torch.where(fmask, 1.0, 1e-9))
    return H, torch.where(fmask, 0.0, b)


def _chi2_total(chi2_f, wf_act, chi2_b, wb_act, huber_delta, use_huber: bool):
    d2 = huber_delta * huber_delta

    def rho(c):
        if not use_huber:
            return c
        return torch.where(c > d2, 2.0 * huber_delta * torch.sqrt(torch.clamp(c, min=0.0)) - d2,
                           c)

    return torch.sum(rho(chi2_f) * wf_act) + torch.sum(rho(chi2_b) * wb_act)


def bundle_adjust(cam: CameraConfig, ba: BAConfig, poses0, fixed, front: PointBlocks,
                  bird: PointBlocks, odom: OdomEdges, n_iters_1: int | None = None,
                  n_iters_2: int | None = None, odom_chunks=None,
                  group: dist.ProcessGroup | None = None) -> BAResult:
    """Two LM stages like the reference's local BA (``Optimizer.cc:2511-2572``):
    ``n_iters_1`` robust iterations (default ``local_ba_iters_1``), the outlier
    re-gate (chi2 above 5.991 or negative depth), ``n_iters_2`` iterations
    without the robust kernel (default ``local_ba_iters_2``), then the final
    classification (``:2574-2610``).  A step is
    kept where the total chi2 drops; the damping halves on a kept step and
    quadruples otherwise.  Every decision is a device-side select.
    ``odom_chunks``: the chunks of ``odom`` that hold a valid edge
    (``edge_blocks``).  ``group``: sum the landmark shards' terms over this
    process group (see the module's docstring); None runs the same ops on
    the whole problem."""
    K = poses0.shape[0]

    def shard_sum(x):
        if group is not None:
            dist.all_reduce(x, group=group)
        return x
    f_act0 = front.valid & front.point_valid[:, None]
    b_act0 = bird.valid & bird.point_valid[:, None]

    def chi2_of(poses, fXw, bXw, f_act, b_act, use_huber):
        c2f, _ = _family_chi2(cam, poses, front._replace(Xw=fXw), ba.w_front, True)
        c2b, _ = _family_chi2(None, poses, bird._replace(Xw=bXw), ba.w_bird, False)
        c2o = _odom_chi2(poses, odom, ba.w_pose)
        return shard_sum(_chi2_total(c2f, f_act, c2b, b_act, ba.huber_delta, use_huber)) \
            + torch.sum(c2o)

    def backsub(Hppi, bp, Hcp, kf_idx, dxc):
        corr = torch.einsum("pmij,pmi->pj", Hcp, dxc[kf_idx.long()])
        return torch.einsum("pij,pj->pi", Hppi, bp - corr)

    def lm_stage(poses, fXw, bXw, f_act, b_act, n_iters, use_huber):
        if n_iters == 0:
            return poses, fXw, bXw
        f_actf, b_actf = f_act.to(torch.float32), b_act.to(torch.float32)
        lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
        err = chi2_of(poses, fXw, bXw, f_actf, b_actf, use_huber)
        for _ in range(n_iters):
            e_f, Jc_f, Jp_f, w_f = _family_terms(cam, poses, front._replace(Xw=fXw), ba.w_front,
                                                 ba.huber_delta, use_huber, f_actf, True)
            e_b, Jc_b, Jp_b, w_b = _family_terms(None, poses, bird._replace(Xw=bXw), ba.w_bird,
                                                 ba.huber_delta, use_huber, b_actf, False)
            Hcc_f, bc_f, Hppi_f, bp_f, Hcp_f = _accumulate_family(K, e_f, Jc_f, Jp_f, w_f,
                                                                  front.kf_idx, lam)
            Hcc_b, bc_b, Hppi_b, bp_b, Hcp_b = _accumulate_family(K, e_b, Jc_b, Jp_b, w_b,
                                                                  bird.kf_idx, lam)
            Hcc_o, bc_o = _odom_terms(K, poses, odom, ba.w_pose, odom_chunks)
            dxc = _solve_reduced(shard_sum(Hcc_f + Hcc_b) + Hcc_o, shard_sum(bc_f + bc_b) + bc_o,
                                 fixed, lam)
            dxf = backsub(Hppi_f, bp_f, Hcp_f, front.kf_idx, dxc)
            dxb = backsub(Hppi_b, bp_b, Hcp_b, bird.kf_idx, dxc)
            poses_new = torch.where(fixed[:, None], poses, se3.retract(poses, dxc))
            fXw_new = fXw + dxf * front.point_valid[:, None]
            bXw_new = bXw + dxb * bird.point_valid[:, None]
            err_new = chi2_of(poses_new, fXw_new, bXw_new, f_actf, b_actf, use_huber)
            ok = torch.isfinite(err_new) & (err_new < err)
            poses = torch.where(ok, poses_new, poses)
            fXw = torch.where(ok, fXw_new, fXw)
            bXw = torch.where(ok, bXw_new, bXw)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e4)
            err = torch.where(ok, err_new, err)
        return poses, fXw, bXw

    def classify(poses, fXw, bXw):
        c2f, f_depth = _family_chi2(cam, poses, front._replace(Xw=fXw), ba.w_front, True)
        c2b, _ = _family_chi2(None, poses, bird._replace(Xw=bXw), ba.w_bird, False)
        return (f_act0 & (c2f <= ba.chi2_mono_ba * ba.w_front) & f_depth,
                b_act0 & (c2b <= ba.chi2_bird * ba.w_bird))

    it1 = ba.local_ba_iters_1 if n_iters_1 is None else n_iters_1
    it2 = ba.local_ba_iters_2 if n_iters_2 is None else n_iters_2
    poses, fXw, bXw = lm_stage(poses0, front.Xw, bird.Xw, f_act0, b_act0, it1, True)
    f_act1, b_act1 = classify(poses, fXw, bXw)
    poses, fXw, bXw = lm_stage(poses, fXw, bXw, f_act1, b_act1, it2, False)
    f_in, b_in = classify(poses, fXw, bXw)
    return BAResult(poses, fXw, bXw, f_in, b_in)
