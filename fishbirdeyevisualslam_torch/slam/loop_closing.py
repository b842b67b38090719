"""Loop detection, loop correction and relocalization — the port of
``fishbirdeyevisualslam_tpu/slam/loop_closing.py`` (the reference's
LoopClosing thread, ``src/LoopClosing.cc``, and KeyFrameDatabase,
``src/KeyFrameDatabase.cc``):

  * ``detect_loop_groups``: BoW scores of the current keyframe against every
    keyframe, accumulated over covisibility groups (``DetectLoop``,
    ``LoopClosing.cc:106-232``); the 3-keyframe consistency is host state in
    ``LoopCloser``;
  * ``compute_loop_transform``: dense descriptor matches between the two
    keyframes' front map points and bird keypoints, a fixed-scale Horn
    RANSAC, then a pose-optimisation refinement (``ComputeSim3``,
    ``:234-403``), and ``verify_loop_projection``, its final gate;
  * the correction: ``seed_loop_correction``, ``search_and_fuse``,
    ``loop_essential_graph`` and ``global_ba`` (``CorrectLoop``,
    ``:405-614``; ``RunGlobalBundleAdjustment``, ``:674-841``), or under
    ``fix_scale = False`` the Sim3 ``correct_loop``, ``search_and_fuse`` and
    ``global_ba``;
  * relocalization: BoW group candidates, node-gated matching and RANSAC PnP
    (``Tracking::Relocalization``, ``Tracking.cc:2231-2392``).

Keyframe slots are host integers.  The RANSACs' Gumbel noise is an input,
drawn on the host (``LoopCloser.draws``, ``SlamSystem.draws``).  The
refinement of ``compute_loop_transform`` is one launch of the fused pose
kernel on a CUDA device (``solvers/cuda_pose_opt.py``), the plain LM on the
CPU.  The two dense matches of ``compute_loop_transform``, the F x P match
of ``verify_loop_projection`` and the P x F match of the fusion are the
+/-1 bf16 contraction of ``ops/matcher.py``, as the JAX package computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import upload
from fishbirdeyevisualslam_torch.geometry import camera as cam_ops
from fishbirdeyevisualslam_torch.geometry import ipm, se3, sim3
from fishbirdeyevisualslam_torch.ops import bow, matcher
from fishbirdeyevisualslam_torch.slam import map_state as ms
from fishbirdeyevisualslam_torch.slam.frame import desc_pm1_from_packed, inv_level_sigma2_lut
from fishbirdeyevisualslam_torch.slam.tracking import _mask_lookup, _topk_stable, odom_chain_edges
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
from fishbirdeyevisualslam_torch.solvers.ba import PointBlocks, bundle_adjust
from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws
from fishbirdeyevisualslam_torch.solvers.pnp import ransac_pnp
from fishbirdeyevisualslam_torch.solvers.pose_graph import (
    build_pose_graph_edges, carry_points, optimize_pose_graph)
from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
from fishbirdeyevisualslam_torch.solvers.sim3_pose_graph import (
    Sim3Edges, carry_points_sim3, optimize_sim3_pose_graph)
from fishbirdeyevisualslam_torch.solvers.sim3_solver import ransac_sim3

RANSAC_ITERS = 128   # hypotheses of ransac_sim3 and ransac_pnp
GROUP_NEIGHBORS = 10   # a covisibility group: a keyframe and its most covisible ones
N_TOP_GROUPS = 5       # groups kept by the loop and relocalization retrievals
FUSE_TARGETS = 4       # search_and_fuse: the current keyframe and its 3 most covisible
GLOBAL_BA_ITERS = 10
CONSISTENCY_NEEDED = 3   # keyframes in a row whose candidate groups must chain
MAX_CANDIDATES = 3       # consistent candidates tried per keyframe
LOOP_COOLDOWN = 10       # insertions after a closure before detection resumes


class LoopGroups(NamedTuple):
    best_member: torch.Tensor  # (N_TOP_GROUPS,) int32 best-scoring member of each group
    acc: torch.Tensor          # (N_TOP_GROUPS,) accumulated group score, -1 for none
    groups: torch.Tensor       # (N_TOP_GROUPS, K) bool group members
    min_score: torch.Tensor    # () the covisible neighbours' lowest score


def _group_of(C, kf: int, valid):
    """``kf`` and its covisible keyframes."""
    K = C.shape[0]
    return ((C[kf] > 0) | (torch.arange(K, device=C.device) == kf)) & valid


def detect_loop_scores(m: ms.MapState, cur_kf: int, cfg: SystemConfig):
    """(scores (K,), min_score, eligible (K,)): the current keyframe's BoW
    scores against every keyframe, the lowest among its covisible
    neighbours, and the candidates: valid, not covisible, more than 10
    insertions apart (insertion sequence, not slot)."""
    return _detect_loop_scores_from_covis(m, cur_kf, ms.covisibility_counts(m))


def _detect_loop_scores_from_covis(m: ms.MapState, cur_kf: int, C):
    K = m.K
    scores = bow.score_against_keyframes(m.kf_words[cur_kf], m.kf_kp_valid[cur_kf], m.kf_words,
                                         m.kf_kp_valid)
    covis = C[cur_kf] > 0
    neigh = torch.where(covis & m.kf_valid, scores, torch.inf)
    min_score = torch.clamp(torch.min(neigh), max=1.0)
    idx = torch.arange(K, device=C.device)
    eligible = m.kf_valid & ~covis & (idx != cur_kf) \
        & (torch.abs(m.kf_seq - m.kf_seq[cur_kf]) > 10)
    return scores, min_score, eligible


def _covis_group_masks(C, valid):
    """(K, K) bool: row k is k's covisibility group, k and its
    ``GROUP_NEIGHBORS`` most covisible keyframes (``KeyFrameDatabase.cc:145-172``)."""
    K = C.shape[0]
    eye = torch.eye(K, dtype=torch.bool, device=C.device)
    w = torch.where(valid[None, :] & valid[:, None], C, -1)
    w = torch.where(eye, -1, w)
    thresh = torch.topk(w, min(GROUP_NEIGHBORS, K), dim=1).values[:, -1]
    return ((w > 0) & (w >= torch.clamp(thresh, min=1)[:, None])) | eye


def _accumulate_groups(scores, cand, groups):
    """Each candidate group's summed score and best member; groups within 75%
    of the best survive; the top ``N_TOP_GROUPS`` (equal scores in index
    order)."""
    s = torch.where(groups & cand[None, :], scores[None, :], 0.0)
    acc = torch.where(cand, torch.sum(s, dim=1), -1.0)
    best_member = torch.argmax(s, dim=1).to(torch.int32)
    acc = torch.where(acc >= 0.75 * torch.max(acc), acc, -1.0)
    top_acc, top_idx = _topk_stable(acc, N_TOP_GROUPS)
    return best_member[top_idx], top_acc, top_idx


def detect_loop_groups(m: ms.MapState, cur_kf: int, cfg: SystemConfig) -> LoopGroups:
    """Covisibility-group accumulated loop retrieval
    (``KeyFrameDatabase::DetectLoopCandidates``, ``KeyFrameDatabase.cc:145-196``):
    candidates score at least max(min_score, 0.02)."""
    C = ms.covisibility_counts(m)
    scores, min_score, eligible = _detect_loop_scores_from_covis(m, cur_kf, C)
    cand = eligible & (scores >= torch.clamp(min_score, min=0.02))
    groups = _covis_group_masks(C, m.kf_valid)
    best, acc, top_idx = _accumulate_groups(scores, cand, groups)
    return LoopGroups(best, acc, groups[top_idx], min_score)


def _loop_pairs(m: ms.MapState, cur_kf: int, cand_kf: int, cfg: SystemConfig):
    """The 3D-3D pairs of a loop: front features of both keyframes that carry
    a map point, matched densely (ratio 0.75), and bird keypoints lifted
    through each keyframe's pose.  Returns (p_cur (F+FB, 3), p_loop, ok,
    p_loop front (F, 3), pb_loop (FB, 3), ok front, ok bird)."""
    F = m.kf_uv.shape[1]
    FB = m.kf_bird_cam.shape[1]
    P = m.mp_pos.shape[0]
    has1 = m.kf_kp_valid[cur_kf] & (m.kf_mp[cur_kf] >= 0)
    has2 = m.kf_kp_valid[cand_kf] & (m.kf_mp[cand_kf] >= 0)
    res = matcher.match(desc_pm1_from_packed(m.kf_desc[cur_kf]),
                        desc_pm1_from_packed(m.kf_desc[cand_kf]),
                        has1[:, None] & has2[None, :], max_dist=50.0, ratio=0.75)
    res = matcher.resolve_duplicates(res, F)
    pid1 = m.kf_mp[cur_kf].clamp(0, P - 1).long()
    pid2 = m.kf_mp[cand_kf][res.idx.clamp(0, F - 1).long()].clamp(0, P - 1).long()
    ok = res.ok & m.mp_valid[pid1] & m.mp_valid[pid2]
    p_cur, p_loop = m.mp_pos[pid1], m.mp_pos[pid2]

    gate_b = m.kf_bird_kp_valid[cur_kf][:, None] & m.kf_bird_kp_valid[cand_kf][None, :]
    res_b = matcher.match(desc_pm1_from_packed(m.kf_bird_desc[cur_kf]),
                          desc_pm1_from_packed(m.kf_bird_desc[cand_kf]), gate_b, max_dist=50.0,
                          ratio=0.75)
    res_b = matcher.resolve_duplicates(res_b, FB)
    pb_cur = se3.transform(se3.inverse(m.kf_Tcw[cur_kf]), m.kf_bird_cam[cur_kf])
    pb_loop = se3.transform(se3.inverse(m.kf_Tcw[cand_kf]),
                            m.kf_bird_cam[cand_kf][res_b.idx.clamp(0, FB - 1).long()])
    ok_b = res_b.ok if cfg.flags.have_bird else torch.zeros_like(res_b.ok)
    return (torch.cat([p_cur, pb_cur]), torch.cat([p_loop, pb_loop]), torch.cat([ok, ok_b]),
            p_loop, pb_loop, ok, ok_b)


def compute_loop_transform(m: ms.MapState, cur_kf: int, cand_kf: int, cfg: SystemConfig,
                           gumbel):
    """The loop's correction between two keyframes: (S (8,), n_inliers,
    success).  S maps the current, drifted world onto the loop-consistent
    one (``LoopClosing::ComputeSim3``).  One RANSAC (``gumbel``: its
    (128, F + FB) noise) over the front map-point pairs and the lifted bird
    keypoint pairs; then, at a fixed scale, one pose optimisation of the
    effective camera pose Q = Tcw_cur T^-1 against the loop side's points
    (the ``OptimizeSim3`` analog, ``Optimizer.cc:1560-1777``), kept where it
    retains min(20, the RANSAC's) inliers."""
    F = m.kf_uv.shape[1]
    FB = m.kf_bird_cam.shape[1]
    p_cur, p_loop_all, ok_all, p_loop, pb_loop, ok, ok_b = _loop_pairs(m, cur_kf, cand_kf, cfg)
    out = ransac_sim3(p_loop_all, p_cur, ok_all, gumbel, fix_scale=cfg.flags.fix_scale)
    if not cfg.flags.fix_scale:
        return out.S12, out.n_inliers, out.success
    lut = inv_level_sigma2_lut(cfg, p_cur.device)
    front = FrontObs(Xw=p_loop, uv=m.kf_uv[cur_kf],
                     inv_sigma2=lut[m.kf_octave[cur_kf].clamp(0, lut.shape[0] - 1).long()],
                     valid=out.inliers[:F] & ok)
    bird = BirdObs(Xw=pb_loop, Xc=m.kf_bird_cam[cur_kf],
                   inv_sigma2=torch.ones(FB, dtype=torch.float32, device=p_cur.device),
                   valid=out.inliers[F:] & ok_b)
    Tcw_cur = m.kf_Tcw[cur_kf]
    T0 = sim3.to_se3(out.S12)
    ref = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, se3.compose(Tcw_cur, se3.inverse(T0)),
                                          front, bird)
    T_ref = se3.compose(se3.inverse(ref.Tcw), Tcw_cur)
    good = ref.n_inliers >= torch.clamp(out.n_inliers, max=20)
    S_ref = sim3.from_se3(torch.where(good, T_ref, T0))
    return S_ref, torch.maximum(ref.n_inliers, out.n_inliers), out.success


def verify_loop_projection(m: ms.MapState, cur_kf: int, cand_kf: int, T_corr,
                           cfg: SystemConfig):
    """The final loop gate (``LoopClosing.cc:380-400``): the map points of the
    candidate's covisible neighbourhood, projected into the current keyframe
    under the correction, matched within 10 px; returns the count (0-d)."""
    P = m.mp_pos.shape[0]
    nbhd = _group_of(ms.covisibility_counts(m), cand_kf, m.kf_valid)
    pts = torch.any(_mask_lookup(nbhd, m.obs_kf) & m.obs_valid, dim=1) & m.mp_valid
    Q = se3.compose(m.kf_Tcw[cur_kf], se3.inverse(T_corr))
    pc = se3.transform(Q, m.mp_pos)
    uv = cam_ops.project_pinhole(cfg.camera, pc)
    cam = cfg.camera
    vis = pts & (pc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    d_feat = desc_pm1_from_packed(m.kf_desc[cur_kf])
    gate = m.kf_kp_valid[cur_kf][:, None] & vis[None, :] \
        & matcher.window_mask(m.kf_uv[cur_kf], uv, 10.0)
    res = matcher.match(d_feat, m.mp_desc_pm1.to(d_feat.dtype), gate,
                        max_dist=float(cfg.matcher.th_low))
    return matcher.resolve_duplicates(res, P).count


def _carry_all(m: ms.MapState, poses_old, poses_new) -> ms.MapState:
    """The map with keyframe poses ``poses_new`` and every valid landmark
    moved with its reference keyframe."""
    K = m.K
    mp_new = carry_points(m.mp_pos, m.mp_ref_kf.clamp(0, K - 1), poses_old, poses_new)
    bp_new = carry_points(m.bp_pos, m.bp_ref_kf.clamp(0, K - 1), poses_old, poses_new)
    return m._replace(kf_Tcw=poses_new,
                      mp_pos=torch.where(m.mp_valid[:, None], mp_new, m.mp_pos),
                      bp_pos=torch.where(m.bp_valid[:, None], bp_new, m.bp_pos))


def seed_loop_correction(m: ms.MapState, cur_kf: int, loop_kf: int, T_corr,
                         cfg: SystemConfig) -> ms.MapState:
    """The first half of ``CorrectLoop`` (``LoopClosing.cc:460-525``): the SE3
    correction applied to the current keyframe's covisible group, their
    landmarks (front and bird) carried along."""
    group = _group_of(ms.covisibility_counts(m), cur_kf, m.kf_valid)
    poses_old = m.kf_Tcw
    corrected = se3.compose(poses_old, se3.inverse(T_corr))
    return _carry_all(m, poses_old, torch.where(group[:, None], corrected, poses_old))


def _fuse_points_into_kf(m: ms.MapState, pts_mask, kf: int, cfg: SystemConfig) -> ms.MapState:
    """``SearchAndFuse``'s inner step (``ORBmatcher::Fuse``): project a
    landmark set into keyframe ``kf`` (4 px window); a hit on a free feature
    registers an observation, a hit on a feature bound to another point
    replaces that point with the projected one (``MapPoint::Replace``).  The
    free hits' ``kf_mp`` rows are written through the hits only (the JAX
    package routes the other rows to feature F-1, and a hit there can lose
    its write; ROADMAP, queue 3)."""
    F = m.kf_uv.shape[1]
    P = m.mp_pos.shape[0]
    dev = m.mp_pos.device
    pc = se3.transform(m.kf_Tcw[kf], m.mp_pos)
    uv_proj = cam_ops.project_pinhole(cfg.camera, pc)
    vis = pts_mask & m.mp_valid & (pc[:, 2] > 0.1)
    compat = matcher.window_mask(uv_proj, m.kf_uv[kf], 4.0) & vis[:, None] \
        & m.kf_kp_valid[kf][None, :]
    res = matcher.match(m.mp_desc_pm1, desc_pm1_from_packed(m.kf_desc[kf]), compat,
                        max_dist=float(cfg.matcher.th_low))
    res = matcher.resolve_duplicates(res, F)
    ok = res.ok & vis
    feat = res.idx.clamp(0, F - 1)
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    kf_t = torch.full((), kf, dtype=torch.int32, device=dev)
    cur_pt = m.kf_mp[kf][feat.long()]
    free_hit = ok & (cur_pt < 0)
    dup_hit = ok & (cur_pt >= 0) & (cur_pt != pid)

    m = ms.add_observation(m, pid, kf_t, feat, free_hit)
    kf_mp = m.kf_mp.clone()
    kf_mp[kf] = ms.put_rows(kf_mp[kf], feat, free_hit, pid)

    loser = cur_pt.clamp(0, P - 1)
    do_merge = dup_hit & m.mp_valid[loser.long()]
    mf = do_merge.to(torch.int32)
    tgt = torch.where(do_merge, loser, 0).long()
    cnt = torch.zeros(P, dtype=torch.int32, device=dev).index_add(0, tgt, mf)
    wsum = torch.zeros(P, dtype=torch.int32, device=dev).index_add(0, tgt, pid * mf)
    unique = cnt == 1
    redirect = torch.where(unique, wsum, pid)
    do_merge = do_merge & unique[loser.long()]
    kf_mp = torch.where(kf_mp >= 0, redirect[kf_mp.clamp(0, P - 1).long()], -1)
    lose = ms.put_rows(torch.zeros(P, dtype=torch.bool, device=dev), loser, do_merge,
                       torch.ones_like(do_merge))
    mp_valid = m.mp_valid & ~lose
    m = m._replace(kf_mp=kf_mp, mp_valid=mp_valid, obs_valid=m.obs_valid & mp_valid[:, None])
    return ms.add_observation(m, pid, kf_t, feat, do_merge)


def search_and_fuse(m: ms.MapState, cur_kf: int, loop_kf: int,
                    cfg: SystemConfig) -> ms.MapState:
    """``SearchAndFuse`` and the loop connections (``LoopClosing.cc:571-616``):
    the loop side's landmarks (observed by the loop keyframe's covisible
    group) fused into the current keyframe and its ``FUSE_TARGETS - 1`` most
    covisible neighbours, in that order (one host read of the targets).  The
    new cross-loop observations are the loop connections."""
    K = m.K
    C = ms.covisibility_counts(m)
    loop_group = _group_of(C, loop_kf, m.kf_valid)
    loop_pts = torch.any(_mask_lookup(loop_group, m.obs_kf) & m.obs_valid, dim=1) & m.mp_valid
    w = torch.where(m.kf_valid & (torch.arange(K, device=C.device) != cur_kf), C[cur_kf], -1)
    ww, nb = _topk_stable(w, FUSE_TARGETS - 1)
    nb, ok = torch.stack([nb.to(torch.int32), (ww > 0).to(torch.int32)]).tolist()
    # a target whose weight is not positive is fused with an empty mask in the
    # JAX package's scan, which changes nothing after the first target's step
    for kf in [cur_kf] + [k for k, o in zip(nb, ok) if o]:
        m = _fuse_points_into_kf(m, loop_pts, kf, cfg)
    return ms.scrub_stale_refs(m)


def loop_essential_graph(m: ms.MapState, cur_kf: int, loop_kf: int, poses_meas,
                         cfg: SystemConfig) -> ms.MapState:
    """The second half of ``CorrectLoop``: the SE3 essential graph (after the
    fusion, so the loop connections are in it) with the loop edge and the
    loop keyframe fixed, ``poses_meas`` the poses the edges are measured at;
    landmarks carried with their reference keyframes."""
    K = m.K
    dev = m.kf_Tcw.device
    fixed = ~m.kf_valid | (torch.arange(K, device=dev) == loop_kf)
    loop_T = se3.compose(m.kf_Tcw[cur_kf], se3.inverse(m.kf_Tcw[loop_kf]))[None]
    ij = lambda k: torch.full((1,), k, dtype=torch.int32, device=dev)
    edges = build_pose_graph_edges(cfg, poses_meas, ms.covisibility_counts(m),
                                   ms.bird_covisibility_counts(m), m.kf_valid, m.kf_seq,
                                   ij(cur_kf), ij(loop_kf), loop_T)
    return _carry_all(m, m.kf_Tcw, optimize_pose_graph(cfg, m.kf_Tcw, fixed, edges))


def correct_loop(m: ms.MapState, cur_kf: int, loop_kf: int, S_corr,
                 cfg: SystemConfig) -> ms.MapState:
    """The single-shot loop correction (``CorrectLoop``, ``LoopClosing.cc:405-614``):
    ``S_corr`` (8,) maps the current, drifted world onto the loop-consistent
    one, X' = S X and Scw' = Scw S^-1 for the current keyframe's covisible
    group; then the essential graph with the loop edge (its measurement the
    relative pose after the seed) and the loop keyframe fixed, over the
    measurement-time poses; landmarks carried with their reference keyframe.

    With ``cfg.flags.fix_scale`` the correction and the graph are SE3
    (``solvers/pose_graph.py``); without it, Sim3 (``solvers/sim3_pose_graph.py``,
    the monocular scale-drift regime), the SE3 edge assembly giving the
    topology and the measurements, and the poses written back without scale
    (t / s).  ``LoopCloser`` takes this route for ``fix_scale = False``; the
    SE3 route of the default goes through ``seed_loop_correction``,
    ``search_and_fuse`` and ``loop_essential_graph`` instead (the reference's
    fuse-before-graph order)."""
    K = m.K
    dev = m.kf_Tcw.device
    C = ms.covisibility_counts(m)
    Cb = ms.bird_covisibility_counts(m)
    poses_old = m.kf_Tcw
    group = _group_of(C, cur_kf, m.kf_valid)
    ij = lambda k: torch.full((1,), k, dtype=torch.int32, device=dev)
    fixed = ~m.kf_valid | (torch.arange(K, device=dev) == loop_kf)
    mp_ref, bp_ref = m.mp_ref_kf.clamp(0, K - 1), m.bp_ref_kf.clamp(0, K - 1)
    if cfg.flags.fix_scale:
        corrected = se3.compose(poses_old, se3.inverse(sim3.to_se3(S_corr)))
        poses_seed = torch.where(group[:, None], corrected, poses_old)
        loop_T = se3.compose(poses_seed[cur_kf], se3.inverse(poses_seed[loop_kf]))[None]
        edges = build_pose_graph_edges(cfg, poses_old, C, Cb, m.kf_valid, m.kf_seq, ij(cur_kf),
                                       ij(loop_kf), loop_T)
        return _carry_all(m, poses_old, optimize_pose_graph(cfg, poses_seed, fixed, edges))
    S_old = sim3.from_se3(poses_old)
    corrected = sim3.compose(S_old, sim3.inverse(S_corr))
    S_seed = torch.where(group[:, None], corrected, S_old)
    loop_S = sim3.compose(S_seed[cur_kf], sim3.inverse(S_seed[loop_kf]))[None]
    e = build_pose_graph_edges(cfg, poses_old, C, Cb, m.kf_valid, m.kf_seq, ij(cur_kf),
                               ij(loop_kf), sim3.to_se3(loop_S))
    S_meas = torch.cat([sim3.from_se3(e.T_meas[:-1]), loop_S])
    S_new = optimize_sim3_pose_graph(S_seed, fixed, Sim3Edges(e.i, e.j, S_meas, e.info, e.valid))
    mp_new = carry_points_sim3(m.mp_pos, mp_ref, S_old, S_new)
    bp_new = carry_points_sim3(m.bp_pos, bp_ref, S_old, S_new)
    return m._replace(kf_Tcw=sim3.to_se3(S_new),
                      mp_pos=torch.where(m.mp_valid[:, None], mp_new, m.mp_pos),
                      bp_pos=torch.where(m.bp_valid[:, None], bp_new, m.bp_pos))


def map_point_blocks(m: ms.MapState, cfg: SystemConfig):
    """The map as (front, bird) ``PointBlocks``: every landmark with its
    observations, the problem of a whole-map BA."""
    lut = inv_level_sigma2_lut(cfg, m.mp_pos.device)
    n = lut.shape[0]
    ok, of = m.obs_kf.long(), m.obs_feat.long()
    front = PointBlocks(Xw=m.mp_pos, kf_idx=m.obs_kf, meas=m.kf_uv[ok, of],
                        inv_sigma2=lut[m.kf_octave[ok, of].clamp(0, n - 1).long()],
                        valid=m.obs_valid, point_valid=m.mp_valid)
    bk, bf = m.bobs_kf.long(), m.bobs_feat.long()
    bird = PointBlocks(Xw=m.bp_pos, kf_idx=m.bobs_kf, meas=m.kf_bird_cam[bk, bf],
                       inv_sigma2=lut[m.kf_bird_octave[bk, bf].clamp(0, n - 1).long()],
                       valid=m.bobs_valid, point_valid=m.bp_valid)
    return front, bird


def global_ba(m: ms.MapState, cfg: SystemConfig) -> ms.MapState:
    """``GlobalBundleAdjustemntWithOdom`` over the whole map: front, bird and
    the odometry chain in insertion order; the first keyframe and the
    ``isInit`` ones fixed; ``GLOBAL_BA_ITERS`` robust LM iterations."""
    front, bird = map_point_blocks(m, cfg)
    odom = odom_chain_edges(m, cfg, m.kf_valid)
    fixed = ~m.kf_valid | (m.kf_seq == 0) | m.kf_is_init
    out = bundle_adjust(cfg.camera, cfg.ba, m.kf_Tcw, fixed, front, bird, odom,
                        n_iters_1=GLOBAL_BA_ITERS, n_iters_2=0)
    return m._replace(
        kf_Tcw=out.poses,
        mp_pos=torch.where(m.mp_valid[:, None], out.front_Xw, m.mp_pos),
        bp_pos=torch.where(m.bp_valid[:, None], out.bird_Xw, m.bp_pos),
        obs_valid=m.obs_valid & out.front_inlier,
        bobs_valid=m.bobs_valid & out.bird_inlier)


def relocalize_candidates(m: ms.MapState, frame_words, cfg: SystemConfig, frame_kp_valid):
    """BoW scores of a lost frame against every keyframe."""
    return bow.score_against_keyframes(frame_words, frame_kp_valid, m.kf_words, m.kf_kp_valid)


def relocalize_group_candidates(m: ms.MapState, frame_words, cfg: SystemConfig, frame_kp_valid):
    """Covisibility-group accumulated relocalization retrieval
    (``KeyFrameDatabase::DetectRelocalizationCandidates``,
    ``KeyFrameDatabase.cc:199-310``): (best member (N_TOP_GROUPS,),
    accumulated score (N_TOP_GROUPS,)); an entry with a score <= 0 is no
    candidate."""
    scores = relocalize_candidates(m, frame_words, cfg, frame_kp_valid)
    cand = m.kf_valid & (scores > 0.0)
    groups = _covis_group_masks(ms.covisibility_counts(m), m.kf_valid)
    best, acc, _ = _accumulate_groups(scores, cand, groups)
    return best, acc


def relocalize_against(m: ms.MapState, f_desc_pm1, f_words, cfg: SystemConfig, f_uv, f_kp_valid,
                       cand_kf: int, gumbel):
    """The frame matched against one keyframe's map points (node-gated, ratio
    0.75), then RANSAC PnP (``gumbel``: its (128, F) noise).  Returns (Tcw,
    map point per feature (F,), n_inliers, success)."""
    F = f_uv.shape[0]
    P = m.mp_pos.shape[0]
    has2 = m.kf_kp_valid[cand_kf] & (m.kf_mp[cand_kf] >= 0)
    gate = bow.node_gate_mask(f_words, f_kp_valid, m.kf_words[cand_kf], has2)
    res = matcher.match(f_desc_pm1, desc_pm1_from_packed(m.kf_desc[cand_kf]), gate,
                        max_dist=50.0, ratio=0.75)
    res = matcher.resolve_duplicates(res, F)
    pid = m.kf_mp[cand_kf][res.idx.clamp(0, F - 1).long()].clamp(0, P - 1)
    ok = res.ok & m.mp_valid[pid.long()]
    out = ransac_pnp(cfg.camera, m.mp_pos[pid.long()], f_uv, ok, gumbel)
    return out.Tcw, torch.where(ok & out.inliers, pid, -1), out.n_inliers, out.success


class LoopCloser:
    """Loop closing's host state: the consistent covisibility groups and the
    cooldown.  A candidate group must share a member with a consistent group
    of the previous keyframe's, ``CONSISTENCY_NEEDED`` keyframes in a row
    (``DetectLoop``, ``LoopClosing.cc:156-222``); after a closure detection
    waits ``LOOP_COOLDOWN`` insertions (``:116``).  Groups are sets of
    keyframe frame ids, which survive slot recycling.

    ``draws(1, 128, n)`` gives each ``compute_loop_transform`` its Gumbel
    noise: a seeded ``GumbelDraws`` (the JAX package's ``PRNGKey(99)``
    chain), replaceable."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.consistent_groups = []   # (member frame ids: frozenset, streak)
        self.last_loop_seq = -1000
        self.draws = GumbelDraws(99)
        self.tracer = None            # an io.tracing.Tracer: the loop_detect span
        # True while an accepted loop is being corrected: with asynchronous
        # mapping, tracking reads it to journal a keyframe instead of asking
        # for an InterruptBA, which cannot stop a correction
        self.correcting = False

    def _span(self, name: str):
        return self.tracer.span(name) if self.tracer is not None else contextlib.nullcontext()

    def _odom_vet(self, m: ms.MapState, cur_kf: int, cand: int, T_corr_se3):
        """The odometry vet's (disagreement, tolerance), m: the corrected SE2
        motion from the candidate to the current keyframe against the wheel
        odometry's, and 0.05 x the path between them + 0.5 m (one host read).
        The loop passes where the disagreement is within the tolerance."""
        K = m.K
        cols = torch.cat([m.kf_odom, m.kf_seq[:, None].to(torch.float32),
                          m.kf_valid[:, None].to(torch.float32)], dim=1)
        h = torch.cat([cols.reshape(-1), m.kf_Tcw[cur_kf], m.kf_Tcw[cand],
                       T_corr_se3.reshape(7)]).cpu()
        tab, Tcur, Tcand, Tc = h[:5 * K].reshape(K, 5), h[5 * K:5 * K + 7], \
            h[5 * K + 7:5 * K + 14], h[5 * K + 14:]
        ex = self.cfg.extrinsics
        Tcw_corr = se3.compose(Tcur, se3.inverse(Tc))
        Twb_cur = ipm.Twb_from_Twc(ex, se3.inverse(Tcw_corr)).numpy()
        Twb_cand = ipm.Twb_from_Twc(ex, se3.inverse(Tcand)).numpy()
        w, x, y, z = Twb_cand[:4]
        yaw_k = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        d = Twb_cur[4:6] - Twb_cand[4:6]
        c, s = np.cos(yaw_k), np.sin(yaw_k)
        rel_slam = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
        od = tab[:, :3].numpy()
        seqs = tab[:, 3].numpy().astype(np.int64)
        valid = tab[:, 4].numpy() > 0
        do = od[cur_kf, :2] - od[cand, :2]
        ck, sk = np.cos(od[cand, 2]), np.sin(od[cand, 2])
        rel_odom = np.array([ck * do[0] + sk * do[1], -sk * do[0] + ck * do[1]])
        lo, hi = sorted((int(seqs[cur_kf]), int(seqs[cand])))
        between = valid & (seqs >= lo) & (seqs <= hi)
        pts = od[between][np.argsort(seqs[between])][:, :2]
        path = float(np.sum(np.hypot(*np.diff(pts, axis=0).T))) if len(pts) > 1 else 0.0
        return float(np.linalg.norm(rel_slam - rel_odom)), 0.05 * path + 0.5

    def process_keyframe(self, m: ms.MapState, cur_kf: int):
        """Loop detection on the keyframe in slot ``cur_kf``, and the
        correction of an accepted loop: seed, fusion, SE3 essential graph and
        global BA, or under ``fix_scale = False`` the Sim3 ``correct_loop``,
        fusion and global BA (``correcting`` is true meanwhile).  Returns
        (map, closed)."""
        cfg = self.cfg
        cur_seq = int(m.kf_seq[cur_kf])
        if cur_seq - self.last_loop_seq < LOOP_COOLDOWN:
            return m, False
        with self._span("loop_detect"):
            g = detect_loop_groups(m, cur_kf, cfg)
            n = g.acc.shape[0]
            h = torch.cat([g.acc, g.best_member.to(torch.float32),
                           g.groups.to(torch.float32).reshape(-1),
                           m.kf_frame_id.to(torch.float32)]).cpu().numpy()
        acc, best_member = h[:n], h[n:2 * n].astype(np.int64)
        group_masks = h[2 * n:2 * n + n * m.K].reshape(n, m.K) > 0
        kf_fids = h[2 * n + n * m.K:].astype(np.int64)
        if acc[0] <= 0.0:
            self.consistent_groups = []
            return m, False
        # group consistency (LoopClosing.cc:170-222): a candidate group extends
        # the streak of any previous consistent group it shares a member with
        new_groups, enough, cand_order = [], [], []
        for gi in range(n):
            if acc[gi] <= 0.0:
                continue
            members = frozenset(int(f) for f in kf_fids[group_masks[gi]] if f >= 0)
            streak = max([s for prev, s in self.consistent_groups if members & prev], default=0)
            new_groups.append((members, streak + 1))
            if streak + 1 >= CONSISTENCY_NEEDED:
                enough.append(int(best_member[gi]))
                cand_order.append(float(acc[gi]))
        self.consistent_groups = new_groups
        if not enough:
            return m, False
        # each consistent group's best candidate in accumulated-score order
        order = [c for _, c in sorted(zip(cand_order, enough), reverse=True)]
        seen = set()
        for cand in order[:MAX_CANDIDATES]:
            if cand in seen:
                continue
            seen.add(cand)
            gumbel = self.draws(1, RANSAC_ITERS, m.kf_uv.shape[1] + m.kf_bird_cam.shape[1])[0]
            S_corr, _, ok = compute_loop_transform(m, cur_kf, cand, cfg,
                                                   upload(gumbel, m.kf_Tcw.device))
            if not bool(ok):
                continue
            # the final gate: >= loop_min_proj_matches neighbourhood points
            # reproject onto the current keyframe under the correction
            T_corr = sim3.to_se3(S_corr)
            if int(verify_loop_projection(m, cur_kf, cand, T_corr, cfg)) \
                    < cfg.tracking.loop_min_proj_matches:
                continue
            # the odometry vet: the corrected motion must agree with the wheel
            # odometry within a budget that grows with the path between them
            if cfg.flags.loose_couple and cfg.tracking.loop_odom_vet:
                disagreement, tolerance = self._odom_vet(m, cur_kf, cand, T_corr)
                if disagreement > tolerance:
                    continue
            self.correcting = True
            try:
                if cfg.flags.fix_scale:
                    # the reference's order: seed -> SearchAndFuse (the loop
                    # connections) -> essential graph -> global BA
                    poses_meas = m.kf_Tcw
                    m = seed_loop_correction(m, cur_kf, cand, T_corr, cfg)
                    m = search_and_fuse(m, cur_kf, cand, cfg)
                    m = loop_essential_graph(m, cur_kf, cand, poses_meas, cfg)
                else:
                    m = correct_loop(m, cur_kf, cand, S_corr, cfg)
                    m = search_and_fuse(m, cur_kf, cand, cfg)
                m = global_ba(m, cfg)
            finally:
                self.correcting = False
            self.last_loop_seq = cur_seq
            self.consistent_groups = []
            return m, True
        return m, False
