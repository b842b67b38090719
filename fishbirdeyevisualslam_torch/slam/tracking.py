"""Tracking and local mapping — the port of
``fishbirdeyevisualslam_tpu/slam/tracking.py`` but ``replay_bird_points``
(asynchronous mapping's):
two-view initialization (``MonocularInitialization`` and
``CreateInitialMapMonocular``), ``track_frame_core`` and its callees
(``TrackWithMotionModel``, ``TrackLocalMap`` and the bird matching of
``src/Tracking.cc``), and the keyframe policy, insertion and
``local_mapping_step`` (``LocalMapping.cc``: triangulation, fusion, culls,
landmark statistics, local BA).

Two routes, as in the JAX package: on a CUDA device the projection matches go
through the fused matcher kernels (``ops/cuda_matcher.py``), with candidate
compaction; on the CPU through the dense ``matcher.match``.  Both give the
same results by construction.  The two pose optimisations go through
``solvers/cuda_pose_opt.py``: one kernel launch each on a CUDA device, the
plain LM on the CPU.  Compaction chooses between the compacted and
the full candidate axis on the host, from a count read back from the card —
the host reads of a frame are those counts.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import const, resolve_device, to_device
from fishbirdeyevisualslam_torch.geometry import camera as cam_ops
from fishbirdeyevisualslam_torch.geometry import ipm
from fishbirdeyevisualslam_torch.geometry import odometry as odo
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.ops import cuda_matcher, matcher, vocab
from fishbirdeyevisualslam_torch.slam import map_state as ms
from fishbirdeyevisualslam_torch.slam.frame import Frame, desc_pm1_from_packed, inv_level_sigma2_lut
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
from fishbirdeyevisualslam_torch.solvers import initializer as init_mod
from fishbirdeyevisualslam_torch.solvers.ba import OdomEdges, PointBlocks, bundle_adjust
from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
from fishbirdeyevisualslam_torch.solvers.sim3_solver import horn_alignment
from fishbirdeyevisualslam_torch.solvers.triangulate import triangulate

NOT_INITIALIZED = 0
OK = 1
LOST = 2


class TrackObs(NamedTuple):
    """Associations of the current frame to the map."""

    mp_idx: torch.Tensor  # (F,) int32 map point per front feature, -1 none
    bp_idx: torch.Tensor  # (FB,) int32 bird point per bird feature, -1 none


class TrackCoreOut(NamedTuple):
    """Output of the per-frame tracking core."""

    Tcw: torch.Tensor      # (7,) optimised pose
    mp_idx: torch.Tensor   # (F,) inlier front associations
    bp_idx: torch.Tensor   # (FB,) inlier bird associations
    map: ms.MapState       # map with updated counters + frame-born bird points
    scalars: torch.Tensor  # (7,) int32 [n_motion_matches, n_inliers,
                           #  n_ref_matches_minobs3, n_ref_matches_minobs2,
                           #  n_bird_inliers, n_ref_bird, n_valid_kfs]


def _row(x, i):
    """``x[i]`` for an int or a 0-d tensor index, without a host read."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).to(device=x.device, dtype=torch.long))[0]
    return x[i]


def _remap(r: matcher.MatchResult, sel) -> matcher.MatchResult:
    """Indices into ``sel`` (a compacted candidate axis) -> indices into the full axis."""
    full = sel[r.idx.clamp(0, sel.shape[0] - 1).long()].to(torch.int32)
    return matcher.MatchResult(torch.where(r.idx >= 0, full, -1), r.dist, r.ok)


def match_bird_frames(f1: Frame, cfg: SystemConfig, f2: Frame, T12_b) -> matcher.MatchResult:
    """``ORBmatcher::BirdviewMatch`` (``ORBmatcher.cc:1602-1760``): bird
    keypoints of two frames, gated by a 30 px window in the bird image under
    the relative base transform and the ground-plane check |z| <= 0.2 m."""
    p_in_1 = se3.transform(T12_b, f2.bird_base)
    uv_pred = ipm.base_xy_to_bird_pixel(cfg.bird, p_in_1)
    compat = matcher.window_mask(f1.bird_uv, uv_pred, 30.0)
    z_ok = torch.abs(p_in_1[:, 2]) <= cfg.bird.plane_gate
    compat = compat & f1.bird_kp_valid[:, None] & (f2.bird_kp_valid & z_ok)[None, :]
    res = matcher.match(f1.bird_desc_pm1, f2.bird_desc_pm1, compat,
                        max_dist=float(cfg.matcher.th_low), ratio=cfg.matcher.nn_ratio_tracking)
    return matcher.resolve_duplicates(res, f2.bird_uv.shape[0])


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def match_for_init(f1: Frame, f2: Frame, cfg: SystemConfig) -> matcher.MatchResult:
    """``SearchForInitialization`` (``ORBmatcher.cc:406``): a 100 px window,
    ratio 0.9, rotation consistency and one-to-one.  All levels are searched
    unless ``init_level0_only`` pins the reference's level-0 matching."""
    compat = matcher.window_mask(f1.uv_raw, f2.uv_raw, 100.0)
    compat = compat & f1.kp_valid[:, None] & f2.kp_valid[None, :]
    if cfg.tracking.init_level0_only:
        compat = compat & (f1.octave == 0)[:, None] & (f2.octave == 0)[None, :]
    res = matcher.match(f1.desc_pm1, f2.desc_pm1, compat, max_dist=float(cfg.matcher.th_low),
                        ratio=cfg.matcher.nn_ratio_tracking)
    res = matcher.rotation_consistency(f1.angle, f2.angle, res, cfg.matcher.histo_length)
    return matcher.resolve_duplicates(res, f2.uv_raw.shape[0])


def _bird_pairs(f1: Frame, f2: Frame, cfg: SystemConfig):
    """The bird keypoints of ``f1`` matched in ``f2`` under the odometry
    transform and within 0.15 m of their transported partner (the 3D gate of
    ``FilterBirdOutlier``): (ok (FB,), partner index (FB,))."""
    FB = f1.bird_uv.shape[0]
    T12_b = odo.preintegrate_base(f1.odom, f2.odom)
    bres = match_bird_frames(f1, cfg, f2, T12_b)
    idx = bres.idx.clamp(0, FB - 1)
    p2_in_1 = se3.transform(T12_b, f2.bird_base)
    partner = torch.where(bres.ok[:, None], p2_in_1[idx.long()], 0.0)
    d = torch.linalg.vector_norm(f1.bird_base - partner, dim=-1)
    return bres.ok & (d < 0.15), idx


def _matched_uv2(f1: Frame, f2: Frame, res: matcher.MatchResult):
    P = f1.uv.shape[0]
    return torch.where(res.ok[:, None], f2.uv[res.idx.clamp(0, P - 1).long()], 0.0)


def bird_seeded_init(f1: Frame, f2: Frame, cfg: SystemConfig, res_front: matcher.MatchResult):
    """Two-view initialization seeded by the bird view (an extension of the
    reference): when F/H and the odometry-rotation re-init fail, the bird
    keypoints still carry metric 3D.  The relative pose is solved in closed
    form (Horn) from the matched bird points of the two frames, and the front
    matches are triangulated under it.  Returns (InitResult, n_bird_inliers)."""
    ok3d, idx = _bird_pairs(f1, f2, cfg)
    n_bird = torch.sum(ok3d.to(torch.int32))
    T21 = horn_alignment(f2.bird_cam[idx.long()], f1.bird_cam, ok3d.to(torch.float32))
    nF, maskF, triF = init_mod._census(cfg.camera, se3.quat_to_matrix(T21[:4])[None],
                                       T21[None, 4:], f1.uv, _matched_uv2(f1, f2, res_front),
                                       res_front.ok, 1.0)
    success = n_bird >= cfg.tracking.min_bird_init_matches
    return init_mod.InitResult(success, T21, triF.Xw[0], maskF[0] & success, nF[0],
                               torch.zeros_like(success)), n_bird


def _permute_front(f: Frame, perm) -> Frame:
    """The Frame with its front-keypoint arrays gathered by ``perm``."""
    p = perm.long()
    return f._replace(uv_raw=f.uv_raw[p], uv=f.uv[p], octave=f.octave[p], angle=f.angle[p],
                      desc=f.desc[p], desc_pm1=f.desc_pm1[p], kp_valid=f.kp_valid[p])


def truncate_init_frames(f1: Frame, f2: Frame, res: matcher.MatchResult,
                         init_out: init_mod.InitResult, F: int):
    """Cut the init pair's doubled extraction budget (``Tracking.cc:127-133``)
    down to the keyframe capacity ``F``: matched features first on both
    sides, then the other valid ones (stable orders); the match indices and
    the per-feature init outputs follow the new layout.  ``f2``'s matched
    features are marked through the matched rows only (the JAX package routes
    the other rows to feature F2-1 and may lose its mark there)."""
    F2 = f2.uv.shape[0]
    i32 = torch.int32
    key1 = (res.ok & init_out.triangulated).to(i32) * 4 + res.ok.to(i32) * 2 \
        + f1.kp_valid.to(i32)
    perm1 = torch.argsort(-key1, stable=True)[:F]
    matched2 = ms.put_rows(torch.zeros(F2, dtype=torch.bool, device=res.ok.device),
                           res.idx.clamp(0, F2 - 1), res.ok, res.ok)
    key2 = matched2.to(i32) * 2 + f2.kp_valid.to(i32)
    perm2 = torch.argsort(-key2, stable=True)[:F]
    inv2 = torch.full((F2,), F2, dtype=i32, device=res.ok.device)
    inv2[perm2] = torch.arange(F, dtype=i32, device=res.ok.device)
    idx_new = inv2[res.idx[perm1].clamp(0, F2 - 1).long()]
    ok_new = res.ok[perm1] & (idx_new < F)
    res_new = matcher.MatchResult(torch.where(ok_new, idx_new, -1),
                                  torch.where(ok_new, res.dist[perm1], matcher.BIG), ok_new)
    init_new = init_out._replace(Xw=init_out.Xw[perm1],
                                 triangulated=init_out.triangulated[perm1] & ok_new)
    return _permute_front(f1, perm1), _permute_front(f2, perm2), res_new, init_new


def apply_world_gauge(m: ms.MapState, Tcw1) -> ms.MapState:
    """Re-express a map whose gauge is its first camera (keyframe 0 at the
    identity) in a world where that camera has pose ``Tcw1``: a submap after a
    reset is chained onto the dead-reckoned continuation of the one before,
    so the exported trajectory stays in one world frame."""
    Twc1 = se3.inverse(Tcw1)
    return m._replace(
        kf_Tcw=se3.compose(m.kf_Tcw, Tcw1),
        mp_pos=se3.transform(Twc1, m.mp_pos),
        bp_pos=se3.transform(Twc1, m.bp_pos),
        mp_normal=se3.quat_rotate(Twc1[:4], m.mp_normal),
    )


def create_initial_map(f1: Frame, f2: Frame, init_out: init_mod.InitResult, cfg: SystemConfig,
                       match_res: matcher.MatchResult, frame_ids, device=None) -> ms.MapState:
    """``CreateInitialMapMonocular`` (``Tracking.cc:901-1053``): two keyframes
    (the first the world origin), the triangulated front points (metric
    through the odometry) with their descriptors from ``f2``, and bird points
    from the bird match between the two frames.  The second keyframe's rows
    are written through the matched features only (the JAX package routes
    the other rows to feature F-1 / FB-1, and a match of that feature can
    lose its write there; ROADMAP, queue 3)."""
    dev = resolve_device(device)
    f1, f2 = to_device(f1, dev), to_device(f2, dev)
    init_out, match_res = to_device(init_out, dev), to_device(match_res, dev)
    i32 = torch.int32
    m = ms.empty_map(cfg, device=dev)
    m = _write_kf(m, 0, f1, se3.identity(device=dev), True, int(frame_ids[0]))
    m = _write_kf(m, 1, f2, init_out.T21, False, int(frame_ids[1]))

    F = f1.uv.shape[0]
    ok = match_res.ok & init_out.triangulated
    pt_ids, ok = ms.alloc_slots(m.mp_valid, ok)
    feat2 = match_res.idx.clamp(0, F - 1)
    f2l = feat2.long()
    put = functools.partial(ms.put_rows, idx=pt_ids, ok=ok)
    kf_mp = m.kf_mp.clone()
    kf_mp[0] = torch.where(ok, pt_ids, -1)
    kf_mp[1] = ms.put_rows(kf_mp[1], feat2, ok, pt_ids)
    m = m._replace(
        mp_pos=put(m.mp_pos, values=init_out.Xw),
        mp_desc=put(m.mp_desc, values=f2.desc[f2l]),
        mp_desc_pm1=put(m.mp_desc_pm1, values=f2.desc_pm1[f2l]),
        mp_valid=put(m.mp_valid, values=torch.ones_like(ok)),
        mp_ref_kf=put(m.mp_ref_kf, values=torch.ones(F, dtype=i32, device=dev)),
        mp_first_kf=torch.zeros_like(m.mp_first_kf),
        n_mp=torch.sum(ok.to(i32)).to(i32),
        kf_mp=kf_mp,
    )
    feats1 = torch.arange(F, dtype=i32, device=dev)
    m = ms.add_observation(m, pt_ids, _slot_tensor(0, dev), feats1, ok)
    m = ms.add_observation(m, pt_ids, _slot_tensor(1, dev), feat2, ok)
    if not cfg.flags.have_bird:
        return m

    # bird points: the world is camera 1's frame, so a bird point's world
    # position is its camera-1 position
    FB = f1.bird_uv.shape[0]
    bok, bfeat2 = _bird_pairs(f1, f2, cfg)
    bids, bok = ms.alloc_slots(m.bp_valid, bok)
    put = functools.partial(ms.put_rows, idx=bids, ok=bok)
    kf_bird_mp = m.kf_bird_mp.clone()
    kf_bird_mp[0] = torch.where(bok, bids, -1)
    kf_bird_mp[1] = ms.put_rows(kf_bird_mp[1], bfeat2, bok, bids)
    m = m._replace(
        bp_pos=put(m.bp_pos, values=f1.bird_cam),
        bp_desc=put(m.bp_desc, values=f1.bird_desc),
        bp_desc_pm1=put(m.bp_desc_pm1, values=f1.bird_desc_pm1),
        bp_valid=put(m.bp_valid, values=torch.ones_like(bok)),
        bp_ref_kf=put(m.bp_ref_kf, values=torch.zeros(FB, dtype=i32, device=dev)),
        n_bp=torch.sum(bok.to(i32)).to(i32),
        kf_bird_mp=kf_bird_mp,
    )
    bfeats1 = torch.arange(FB, dtype=i32, device=dev)
    m = ms.add_bird_observation(m, bids, _slot_tensor(0, dev), bfeats1, bok)
    return ms.add_bird_observation(m, bids, _slot_tensor(1, dev), bfeat2, bok)


def _front_gates_arrays(cfg: SystemConfig, Tcw_pred, pos, valid, min_dist, max_dist, normal,
                        cand_mask, frustum_gates: bool):
    """Projection + visibility / scale gating over explicit point arrays.
    Returns (uv_proj, vis, predicted_level, scale_estimated, r_scale)."""
    pc = se3.transform(Tcw_pred, pos)
    uv_proj = cam_ops.project_pinhole(cfg.camera, pc)
    vis = cand_mask & valid & (pc[:, 2] > 0.1)
    vis = vis & (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cfg.camera.width) \
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cfg.camera.height)
    # predicted pyramid level from the scale-invariance range (MapPoint::PredictScale)
    center = se3.inverse(Tcw_pred)[4:]
    rays = pos - center
    dist = torch.clamp(torch.sqrt(torch.sum(rays * rays, dim=-1)), min=1e-6)
    log_sf = math.log(cfg.orb.scale_factor)
    pred = torch.ceil(torch.log(torch.clamp(max_dist, min=1e-6) / dist) / log_sf)
    pred = torch.clamp(pred, 0, cfg.orb.n_levels - 1).to(torch.int32)
    if frustum_gates and cfg.tracking.use_frustum_gates:
        vis = vis & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
        # the viewing-angle gate applies once the mean normal exists: fresh
        # points carry a zero normal
        viewcos = torch.sum(rays * normal, dim=-1) / dist
        has_normal = torch.sum(normal * normal, dim=-1) > 0.25
        vis = vis & ((viewcos > 0.5) | ~has_normal)
    sf_lut = const(cfg.orb.scale_factors(), torch.float32, pos.device)
    # points whose scale range is not yet estimated keep the base radius and
    # are exempt from the octave window
    est = max_dist < 1e8
    r_scale = torch.where(est, sf_lut[pred.long()], 1.0)
    return uv_proj, vis, pred, est, r_scale


def _project_front_gates(m: ms.MapState, cfg: SystemConfig, Tcw_pred, cand_mask,
                         frustum_gates: bool):
    """``_front_gates_arrays`` over every map point: (uv_proj, vis,
    predicted_level, scale_estimated, r_scale)."""
    return _front_gates_arrays(cfg, Tcw_pred, m.mp_pos, m.mp_valid, m.mp_min_dist,
                               m.mp_max_dist, m.mp_normal, cand_mask, frustum_gates)


def _dense_compat(f: Frame, uv_proj, r, pred, est, vis, cfg: SystemConfig):
    d_uv = torch.abs(f.uv[:, None, :] - uv_proj[None, :, :])
    compat = (d_uv[..., 0] <= r[None, :]) & (d_uv[..., 1] <= r[None, :])
    if cfg.tracking.use_level_window:
        d_oct = f.octave[:, None] - pred[None, :]
        compat = compat & (((d_oct >= -1) & (d_oct <= 1)) | ~est[None, :])
    return compat & f.kp_valid[:, None] & vis[None, :]


def _compact_fused_match(vis, cap: int, run_compact, run_full):
    """Candidate compaction for the fused matchers: gather the visible rows
    into a ``cap``-sized prefix when they fit, else run the full axis
    (identical results).  The branch is chosen on the host (one read of the
    visible count).  ``run_compact(sel, mask)`` returns results indexed into
    ``sel``; they are remapped to the full axis here."""
    P = vis.shape[0]
    n_vis = int(torch.sum(vis.to(torch.int32)))
    if n_vis > cap:
        return run_full()
    iota = torch.arange(P, dtype=torch.int32, device=vis.device)
    sel = torch.sort(torch.where(vis, iota, P)).values[:cap]
    sel = torch.clamp(sel, max=P - 1)
    mask = torch.arange(cap, device=vis.device) < n_vis
    return _remap(run_compact(sel, mask), sel)


def match_map_points_dual_ids(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_ids,
                              radius: float, max_dist: float, fused: bool):
    """``TrackWithMotionModel``'s search and its doubled-window retry
    (``Tracking.cc:1358-1365``) over an explicit candidate id list (entries
    < 0 are holes): returns ``(res_radius, res_2x_radius)`` over features."""
    P = m.mp_pos.shape[0]
    C = cand_ids.shape[0]
    sel = cand_ids.clamp(0, P - 1).long()
    uv_proj, vis, pred, est, r_scale = _front_gates_arrays(
        cfg, Tcw_pred, m.mp_pos[sel], m.mp_valid[sel] & (cand_ids >= 0), m.mp_min_dist[sel],
        m.mp_max_dist[sel], m.mp_normal[sel],
        torch.ones((C,), dtype=torch.bool, device=sel.device), False)
    r_pt = radius * r_scale
    if fused:
        res1, res2 = cuda_matcher.fused_projection_match_dual(
            f.desc_pm1, f.uv, f.octave, f.kp_valid, m.mp_desc_pm1[sel], uv_proj, r_pt,
            torch.where(est, pred, -1), vis, max_dist=max_dist, r2_scale=2.0,
            level_window=bool(cfg.tracking.use_level_window))
        res1, res2 = _remap(res1, sel), _remap(res2, sel)
    else:
        res1, res2 = (
            _remap(matcher.match(f.desc_pm1, m.mp_desc_pm1[sel],
                                 _dense_compat(f, uv_proj, r, pred, est, vis, cfg),
                                 max_dist=max_dist), sel)
            for r in (r_pt, 2.0 * r_pt))
    return matcher.resolve_duplicates(res1, P), matcher.resolve_duplicates(res2, P)


def _mask_to_ids(cand_mask, cap: int):
    """A (P,) candidate mask as a candidate id list (holes -1): the ascending
    candidates in a ``cap`` prefix when 0 < cap < P and they fit (one host
    read of their count), else every point."""
    P = cand_mask.shape[0]
    iota = torch.arange(P, dtype=torch.int32, device=cand_mask.device)
    if 0 < cap < P and int(torch.sum(cand_mask.to(torch.int32))) <= cap:
        ids = torch.sort(torch.where(cand_mask, iota, P)).values[:cap]
        return torch.where(ids < P, ids, -1)
    return torch.where(cand_mask, iota, -1)


def match_map_points_dual(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_mask,
                          radius: float, max_dist: float):
    """``match_map_points_dual_ids`` over a (P,) candidate mask, compacted to
    ids by ``_mask_to_ids``: with the fused matcher on the card to a
    ``match_compact_cap`` prefix and matched by kernel 3, otherwise every
    point and the plain matcher.  Both give the mask's results."""
    fused = cfg.tracking.use_fused_matcher and Tcw_pred.device.type == "cuda"
    ids = _mask_to_ids(cand_mask, cfg.tracking.match_compact_cap if fused else 0)
    return match_map_points_dual_ids(m, f, cfg, Tcw_pred, ids, radius, max_dist, fused)


def match_map_points(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_mask,
                     radius: float, max_dist: float, frustum_gates: bool, fused: bool):
    """``SearchByProjection`` against the local map (``ORBmatcher.cc:46``):
    project the candidates, search a window scaled by the predicted pyramid
    level, octave within one level of the prediction, and with
    ``frustum_gates`` the ``Frame::isInFrustum`` distance and viewing-angle
    checks.  Returns (MatchResult over features, vis (P,))."""
    uv_proj, vis, pred, est, r_scale = _project_front_gates(m, cfg, Tcw_pred, cand_mask,
                                                            frustum_gates)
    P = m.mp_pos.shape[0]
    r_pt = radius * r_scale
    mp_pm1 = m.mp_desc_pm1
    if fused:
        fn = cuda_matcher.fused_projection_match
        pred_eff = torch.where(est, pred, -1)
        lw = bool(cfg.tracking.use_level_window)
        cap = cfg.tracking.local_match_compact_cap

        def run_compact(sel, mask):
            s = sel.long()
            return fn(f.desc_pm1, f.uv, f.octave, f.kp_valid, mp_pm1[s], uv_proj[s], r_pt[s],
                      pred_eff[s], mask, max_dist=max_dist, level_window=lw)

        def run_full():
            return fn(f.desc_pm1, f.uv, f.octave, f.kp_valid, mp_pm1, uv_proj, r_pt, pred_eff,
                      vis, max_dist=max_dist, level_window=lw)

        res = _compact_fused_match(vis, cap, run_compact, run_full) if 0 < cap < P \
            else run_full()
    else:
        res = matcher.match(f.desc_pm1, mp_pm1, _dense_compat(f, uv_proj, r_pt, pred, est, vis, cfg),
                            max_dist=max_dist)
    return matcher.resolve_duplicates(res, P), vis


def _bird_vis(cfg: SystemConfig, Tcw_pred, pos, valid):
    """Predicted bird-image positions and the plane gate of bird points."""
    pc = se3.transform(Tcw_pred, pos)
    p_base = ipm.cam_xyz_to_base(cfg.extrinsics, pc)
    uv = ipm.base_xy_to_bird_pixel(cfg.bird, p_base)
    return uv, valid & (torch.abs(p_base[:, 2]) < cfg.bird.plane_gate)


def bird_match_precompact(m: ms.MapState, cfg: SystemConfig, Tcw_pred, cand_mask, fused: bool):
    """The bird matches' candidate compaction, computed once per frame at the
    predicted pose and shared by both bird matches: (sel, mask), or None
    where the compact route does not apply (not fused, or the visible points
    overflow the cap).  One host read (the count)."""
    PB = m.bp_pos.shape[0]
    cap = cfg.tracking.bird_match_compact_cap
    if not (fused and 0 < cap < PB):
        return None
    _, vis = _bird_vis(cfg, Tcw_pred, m.bp_pos, cand_mask & m.bp_valid)
    n_vis = int(torch.sum(vis.to(torch.int32)))
    if n_vis > cap:
        return None
    iota = torch.arange(PB, dtype=torch.int32, device=vis.device)
    sel = torch.clamp(torch.sort(torch.where(vis, iota, PB)).values[:cap],
                      max=PB - 1)
    return sel, torch.arange(cap, device=vis.device) < n_vis


def match_bird_points(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_mask,
                      precomp, fused: bool) -> matcher.MatchResult:
    """``BirdMapPointMatch`` (``ORBmatcher.cc:1763-1902``): project the bird
    points, match in a 30 px bird-image window, then gate coordinate-wise on
    the 3D camera-frame residual |d| < filter_gate_mult * filter_size."""
    PB = m.bp_pos.shape[0]
    bp_pm1 = m.bp_desc_pm1
    th = float(cfg.matcher.th_high)
    fn = cuda_matcher.fused_projection_match

    def run(sel, pos, valid):
        uv, vis = _bird_vis(cfg, Tcw_pred, pos, valid)
        zero = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
        r = fn(f.bird_desc_pm1, f.bird_uv, torch.zeros_like(f.bird_octave), f.bird_kp_valid,
               bp_pm1 if sel is None else bp_pm1[sel.long()], uv, 30.0, zero, vis,
               max_dist=th)
        return r if sel is None else _remap(r, sel)

    if fused and precomp is not None:
        # the shared per-frame compaction: project + gate only the selected rows
        sel, smask = precomp
        s = sel.long()
        res = run(sel, m.bp_pos[s], smask & m.bp_valid[s])
    elif fused:
        res = run(None, m.bp_pos, cand_mask & m.bp_valid)
    else:
        uv, vis = _bird_vis(cfg, Tcw_pred, m.bp_pos, cand_mask & m.bp_valid)
        compat = matcher.window_mask(f.bird_uv, uv, 30.0)
        compat = compat & f.bird_kp_valid[:, None] & vis[None, :]
        res = matcher.match(f.bird_desc_pm1, bp_pm1, compat, max_dist=th)
    pc_of_match = se3.transform(Tcw_pred, m.bp_pos[res.idx.clamp(0, PB - 1).long()])
    d = torch.abs(f.bird_cam - pc_of_match)
    ok = res.ok & torch.all(d < cfg.bird.filter_gate_mult * cfg.bird.filter_size, dim=-1)
    res = matcher.MatchResult(torch.where(ok, res.idx, -1),
                              torch.where(ok, res.dist, matcher.BIG),
                              ok)
    return matcher.resolve_duplicates(res, PB)


def pose_opt_step(m: ms.MapState, f: Frame, assoc: TrackObs, cfg: SystemConfig, Tcw0,
                  prior_T=None):
    """FrontObs/BirdObs from the associations, then the 4x10 LM with the soft
    prior anchored at ``prior_T`` (default ``Tcw0``)."""
    lut = inv_level_sigma2_lut(cfg, Tcw0.device)
    n_lut = lut.shape[0]
    P = m.mp_pos.shape[0]
    PB = m.bp_pos.shape[0]
    pid = assoc.mp_idx.clamp(0, P - 1).long()
    front = FrontObs(Xw=m.mp_pos[pid], uv=f.uv,
                     inv_sigma2=lut[f.octave.clamp(0, n_lut - 1).long()],
                     valid=(assoc.mp_idx >= 0) & m.mp_valid[pid])
    bid = assoc.bp_idx.clamp(0, PB - 1).long()
    bird = BirdObs(Xw=m.bp_pos[bid], Xc=f.bird_cam,
                   inv_sigma2=lut[f.bird_octave.clamp(0, n_lut - 1).long()],
                   valid=(assoc.bp_idx >= 0) & m.bp_valid[bid])
    return cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, Tcw0, front, bird,
                                           prior_T=Tcw0 if prior_T is None else prior_T,
                                           prior_info=cfg.ba.pose_prior_info)


def bird_only_view(f: Frame) -> Frame:
    """The Frame with its front-keypoint arrays cut to shape-(1, ...) zeros:
    bird maintenance reads only the last frame's bird fields and odometry."""
    dev = f.bird_uv.device
    return f._replace(
        uv_raw=torch.zeros((1, 2), device=dev), uv=torch.zeros((1, 2), device=dev),
        octave=torch.zeros((1,), dtype=torch.int32, device=dev),
        angle=torch.zeros((1,), device=dev),
        desc=torch.zeros((1, 8), dtype=torch.int32, device=dev),
        desc_pm1=torch.zeros((1, 256), dtype=f.desc_pm1.dtype, device=dev),
        kp_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
    )


def bird_frame_maintenance(m: ms.MapState, f: Frame, cfg: SystemConfig, last_f: Frame,
                           last_bp_idx, last_Tcw, ref_slot, bp_idx_map, enabled):
    """Per-frame bird landmark maintenance (``Tracking::FilterBirdOutlier`` +
    ``UpdateBirdLocalMap``): match the last and current frames' bird
    keypoints under the odometry transform, gate on the 3D residual, then for
    each current keypoint without a map association SHARE the last frame's
    landmark or CREATE one at the last frame's lifted position.
    Returns (map, bp_idx (FB,)) with map-match > share > create."""
    FB = f.bird_uv.shape[0]
    PB = m.bp_pos.shape[0]
    T_cb = odo.preintegrate_base(f.odom, last_f.odom)  # last base -> current base
    bres = match_bird_frames(f, cfg, last_f, T_cb)
    jlast = bres.idx.clamp(0, FB - 1).long()
    p_last_in_cur = se3.transform(T_cb, last_f.bird_base)
    dd = f.bird_base - p_last_in_cur[jlast]
    d = torch.sqrt(torch.sum(dd * dd, dim=-1))
    pair_ok = bres.ok & (d < 0.15) & enabled
    free_cur = bp_idx_map < 0
    last_pt = last_bp_idx[jlast]
    share = pair_ok & free_cur & (last_pt >= 0) & m.bp_valid[last_pt.clamp(0, PB - 1).long()]
    create = pair_ok & free_cur & (last_pt < 0)
    Xw_last = se3.transform(se3.inverse(last_Tcw), last_f.bird_cam)[jlast]
    dest, can = ms.alloc_slots(m.bp_valid, create)
    m = ms.reset_bird_slots(m, dest, can)
    dl = dest.long()
    col = can[:, None]
    m = m._replace(
        bp_pos=m.bp_pos.index_put((dl,), torch.where(col, Xw_last, m.bp_pos[dl])),
        bp_desc=m.bp_desc.index_put((dl,), torch.where(col, f.bird_desc, m.bp_desc[dl])),
        bp_desc_pm1=m.bp_desc_pm1.index_put((dl,), torch.where(
            col, f.bird_desc_pm1.to(torch.bfloat16), m.bp_desc_pm1[dl])),
        bp_valid=m.bp_valid.index_put((dl,), can | m.bp_valid[dl]),
        bp_ref_kf=m.bp_ref_kf.index_put((dl,), torch.where(can, ref_slot, m.bp_ref_kf[dl])),
        bp_birth=m.bp_birth.index_put((dl,), torch.where(can, m.kf_counter - 1, m.bp_birth[dl])),
        n_bp=m.n_bp + torch.sum(can.to(torch.int32)).to(torch.int32),
    )
    bp_idx = torch.where(share, last_pt, torch.where(can, dest, bp_idx_map))
    return m, bp_idx


def replay_bird_points(m: ms.MapState, live: ms.MapState, born):
    """Re-insert the frame-born bird points that tracking created while an
    asynchronous mapping job ran on a snapshot (the reference keeps every
    frame's ``FilterBirdOutlier`` landmarks whatever LocalMapping is doing,
    ``Tracking.cc:1684-1823``).

    ``m`` is the worker's result, ``live`` the tracking side's map at the
    merge and ``born`` (PB,) its slots allocated since the snapshot.  The
    worker never allocates bird slots (it only frees them), so ``born`` is
    exactly tracking's creations: they get free slots of ``m``, first fit,
    and their fields from ``live``.  Only those rows are written
    (``map_state.put_rows``).

    Returns (map, remap (PB,) int32, dropped): live slot -> slot in the
    result for born points, the identity for slots valid on both sides, -1
    where the point is gone (culled by the worker, or no free slot); and the
    born points dropped for want of a slot (0-d int32)."""
    PB = m.bp_pos.shape[0]
    i32 = torch.int32
    idx = torch.arange(PB, dtype=i32, device=m.bp_pos.device)
    keep = live.bp_valid & ~born & m.bp_valid
    dest, can = ms.alloc_slots(m.bp_valid, born)
    remap = torch.where(born, torch.where(can, dest, -1), torch.where(keep, idx, -1))
    m = ms.reset_bird_slots(m, dest, can)
    put = functools.partial(ms.put_rows, idx=dest, ok=can)
    m = m._replace(
        bp_pos=put(m.bp_pos, values=live.bp_pos),
        bp_desc=put(m.bp_desc, values=live.bp_desc),
        bp_desc_pm1=put(m.bp_desc_pm1, values=live.bp_desc_pm1),
        bp_valid=put(m.bp_valid, values=torch.ones_like(can)),
        bp_ref_kf=put(m.bp_ref_kf, values=live.bp_ref_kf),
        bp_birth=put(m.bp_birth, values=live.bp_birth),
        n_bp=(m.n_bp + torch.sum(can.to(i32))).to(i32),
    )
    return m, remap.to(i32), torch.sum((born & ~can).to(i32)).to(i32)


def local_map_mask(m: ms.MapState, assoc_mp, cfg: SystemConfig):
    """Local-map candidates: points observed by the keyframes that observe the
    frame's matched points (``UpdateLocalKeyFrames/Points``,
    ``Tracking.cc:2085-2229``), at most ``max_local_keyframes`` of them, the
    strongest voters first.  Returns (pt_local (P,), local_kf (K,))."""
    P = m.mp_pos.shape[0]
    K = m.K
    pid = assoc_mp.clamp(0, P - 1).long()
    kf = m.obs_kf[pid]
    ov = m.obs_valid[pid] & (assoc_mp >= 0)[:, None] & (kf >= 0) & (kf < K)
    kf_votes = torch.zeros(K, dtype=torch.int32, device=kf.device).index_add(
        0, kf.clamp(0, K - 1).reshape(-1).long(), ov.reshape(-1).to(torch.int32))
    local_kf = (kf_votes > 0) & m.kf_valid
    cap = min(cfg.tracking.max_local_keyframes, K)
    thresh = torch.topk(torch.where(local_kf, kf_votes, 0), cap).values
    local_kf = local_kf & (kf_votes >= torch.clamp(thresh[cap - 1], min=1))
    in_range = (m.obs_kf >= 0) & (m.obs_kf < K)
    hit = local_kf[m.obs_kf.clamp(0, K - 1).long()] & in_range & m.obs_valid
    return torch.any(hit, dim=1) & m.mp_valid, local_kf


def bird_local_mask(m: ms.MapState, cfg: SystemConfig, Tcw):
    """Bird points whose reference keyframe lies within the 5 m window of the
    current base position (``Map::UpdateLocalBirdMap``, ``Map.cc:97-153``)."""
    Twb_cur = ipm.Twb_from_Twc(cfg.extrinsics, se3.inverse(Tcw))
    Twb_kf = ipm.Twb_from_Twc(cfg.extrinsics, se3.inverse(m.kf_Tcw))
    ref_xy = Twb_kf[m.bp_ref_kf.clamp(0, m.K - 1).long(), 4:6]
    dxy = ref_xy - Twb_cur[4:6]
    d = torch.sqrt(torch.sum(dxy * dxy, dim=-1))
    return m.bp_valid & (d < cfg.tracking.bird_window_meters)


def cull_bird_points(m: ms.MapState, cfg: SystemConfig, Tcw_cur) -> ms.MapState:
    """Retire single-observation bird points that left the 5 m window, or that
    stayed unmatched for more than 4 keyframes after birth."""
    nobs = torch.sum((m.bobs_valid & m.bp_valid[:, None]).to(torch.int32), dim=1)
    in_window = bird_local_mask(m, cfg, Tcw_cur)
    young = (m.kf_counter - 1 - m.bp_birth) <= 4
    keep = m.bp_valid & ((nobs >= 2) | (in_window & young))
    m = m._replace(bp_valid=keep, bobs_valid=m.bobs_valid & keep[:, None])
    return ms.scrub_stale_refs(m)


def track_frame_core(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_last,
                     ref_kf=None, last_f: Frame | None = None, last_bp_idx=None,
                     last_Tcw=None, bird_maint_enabled=True, device=None) -> TrackCoreOut:
    """The OK-state frame step: TrackWithMotionModel (15 px window, 30 px
    retry selected on the device) + bird matching + first pose optimisation +
    TrackLocalMap (frustum-gated local-map match, second pose optimisation) +
    per-frame bird maintenance + found/visible bookkeeping.

    ``cand_last`` is the int32 motion-model candidate id list (entries < 0
    are holes).  Runs on ``device`` (the current CUDA card by default), where
    the projection matches take the fused-kernel route."""
    dev = resolve_device(device)
    if cand_last.dtype == torch.bool:
        raise ValueError("track_frame_core takes an int32 candidate id list, not a (P,) mask")
    m = to_device(m, dev)
    f = to_device(f, dev)
    if last_f is not None:
        last_f = to_device(last_f, dev)
        last_bp_idx = last_bp_idx.to(dev)
        last_Tcw = last_Tcw.to(dev)
    if isinstance(ref_kf, torch.Tensor):
        ref_kf = ref_kf.to(dev)
    if isinstance(bird_maint_enabled, torch.Tensor):
        bird_maint_enabled = bird_maint_enabled.to(dev)
    return _track_frame_core(m, f, cfg, Tcw_pred.to(dev), cand_last.to(dev), ref_kf, last_f,
                             last_bp_idx, last_Tcw, bird_maint_enabled,
                             fused=cfg.tracking.use_fused_matcher and dev.type == "cuda")


def _track_frame_core(m, f, cfg: SystemConfig, Tcw_pred, cand_last, ref_kf, last_f,
                      last_bp_idx, last_Tcw, bird_maint_enabled, fused: bool) -> TrackCoreOut:
    P = m.mp_pos.shape[0]
    FB = f.bird_uv.shape[0]
    th_high = float(cfg.matcher.th_high)
    res15, res30 = match_map_points_dual_ids(m, f, cfg, Tcw_pred, cand_last, 15.0, th_high,
                                             fused)
    use30 = res15.count < cfg.tracking.min_track_matches
    res = matcher.MatchResult(*(torch.where(use30, b, a) for a, b in zip(res15, res30)))
    n_mm = res.count
    # the 5 m bird window and the bird compaction are computed once, at the
    # predicted pose, and reused by the post-optimisation bird match
    if cfg.flags.have_bird:
        bwin = bird_local_mask(m, cfg, Tcw_pred)
        bprec = bird_match_precompact(m, cfg, Tcw_pred, bwin, fused)
        bres_idx = match_bird_points(m, f, cfg, Tcw_pred, bwin, bprec, fused).idx
    else:
        bres_idx = torch.full((FB,), -1, dtype=torch.int32, device=f.uv.device)
    assoc = TrackObs(res.idx, bres_idx)
    out1 = pose_opt_step(m, f, assoc, cfg, Tcw_pred, Tcw_pred)
    ok1 = n_mm >= 10
    Tcw1 = torch.where(ok1, out1.Tcw, Tcw_pred)
    mp1 = torch.where(ok1, torch.where(out1.front_inlier, assoc.mp_idx, -1),
                      assoc.mp_idx)
    bp1 = torch.where(ok1, torch.where(out1.bird_inlier, assoc.bp_idx, -1),
                      assoc.bp_idx)

    # --- TrackLocalMap
    pt_local, _ = local_map_mask(m, mp1, cfg)
    res2, vis2 = match_map_points(m, f, cfg, Tcw1, pt_local, 12.0, th_high, True, fused)
    mp_idx = torch.where(mp1 >= 0, mp1, res2.idx)
    if cfg.flags.have_bird:
        bres2_idx = match_bird_points(m, f, cfg, Tcw1, bwin, bprec, fused).idx
    else:
        bres2_idx = torch.full((FB,), -1, dtype=torch.int32, device=f.uv.device)
    bp_idx = torch.where(bp1 >= 0, bp1, bres2_idx)
    ref_slot = 0 if ref_kf is None else ref_kf
    if cfg.flags.have_bird and last_f is not None:
        m, bp_idx = bird_frame_maintenance(m, f, cfg, last_f, last_bp_idx, last_Tcw, ref_slot,
                                           bp_idx, bird_maint_enabled)
    out2 = pose_opt_step(m, f, TrackObs(mp_idx, bp_idx), cfg, Tcw1, Tcw_pred)
    mp_fin = torch.where(out2.front_inlier, mp_idx, -1)
    bp_fin = torch.where(out2.bird_inlier, bp_idx, -1)
    # found/visible bookkeeping (MapPoint.cc:224-240)
    found = mp_fin >= 0
    m = m._replace(
        mp_visible=m.mp_visible + (vis2 & pt_local).to(torch.int32),
        mp_found=m.mp_found.index_add(
            0, torch.where(found, mp_fin.clamp(0, P - 1), P - 1).long(),
            found.to(torch.int32)))
    if cfg.flags.have_bird and last_f is not None:
        m = cull_bird_points(m, cfg, out2.Tcw)
    # reference-KF tracked-point counts for NeedNewKeyFrame (Tracking.cc:1478-1481)
    rp = _row(m.kf_mp, ref_slot)
    rpc = rp.clamp(0, P - 1).long()
    rp_ok = (rp >= 0) & m.mp_valid[rpc]
    robs = torch.sum((m.obs_valid[rpc] & m.mp_valid[rpc, None]).to(torch.int32), dim=1)
    i32 = torch.int32
    scalars = torch.stack([
        n_mm.to(i32), out2.n_inliers.to(i32),
        torch.sum((rp_ok & (robs >= 3)).to(i32)).to(i32),
        torch.sum((rp_ok & (robs >= 2)).to(i32)).to(i32),
        torch.sum(bp_fin >= 0).to(i32),
        torch.sum(_row(m.kf_bird_mp, ref_slot) >= 0).to(i32),
        torch.sum(m.kf_valid).to(i32),
    ])
    return TrackCoreOut(out2.Tcw, mp_fin, bp_fin, m, scalars)


# ---------------------------------------------------------------------------
# Keyframe insertion and local mapping (``CreateNewKeyFrame`` and the body of
# ``LocalMapping::Run``).  Keyframe slots are host integers here: the caller
# reads the slot once per keyframe, as ``SlamSystem._track_ok`` does.
# ---------------------------------------------------------------------------


def _set_row(x, i: int, v):
    """``x`` with row ``i`` set to ``v``; a Python number is filled in on the
    device (assigning one through indexing copies it from the host, which
    waits for the card)."""
    y = x.clone()
    if isinstance(v, torch.Tensor):
        y[i] = v
    else:
        y[i].fill_(v)
    return y


def _slot_tensor(slot: int, dev):
    """A keyframe slot as a 0-d int32 tensor, filled on ``dev`` (no copy)."""
    return torch.full((), slot, dtype=torch.int32, device=dev)


def _topk_stable(w, k: int):
    """The ``k`` largest of ``w``, equal values in index order (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none).  Returns (values, indices)."""
    vals, idx = torch.sort(w, descending=True, stable=True)
    return vals[:k], idx[:k]


def _write_kf(m: ms.MapState, slot: int, f: Frame, Tcw, is_init: bool, frame_id) -> ms.MapState:
    """Write a keyframe into ``slot``.  Slots recycle, so the slot's
    association rows are reset; callers fill them in afterwards."""
    return m._replace(
        kf_Tcw=_set_row(m.kf_Tcw, slot, Tcw),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_is_init=_set_row(m.kf_is_init, slot, bool(is_init)),
        kf_odom=_set_row(m.kf_odom, slot, f.odom),
        kf_timestamp=_set_row(m.kf_timestamp, slot, f.timestamp),
        kf_frame_id=_set_row(m.kf_frame_id, slot, frame_id),
        kf_seq=_set_row(m.kf_seq, slot, m.kf_counter),
        kf_uv=_set_row(m.kf_uv, slot, f.uv),
        kf_octave=_set_row(m.kf_octave, slot, f.octave),
        kf_desc=_set_row(m.kf_desc, slot, f.desc),
        kf_kp_valid=_set_row(m.kf_kp_valid, slot, f.kp_valid),
        kf_words=_set_row(m.kf_words, slot, vocab.word_ids(f.desc_pm1)),
        kf_bird_cam=_set_row(m.kf_bird_cam, slot, f.bird_cam),
        kf_bird_desc=_set_row(m.kf_bird_desc, slot, f.bird_desc),
        kf_bird_octave=_set_row(m.kf_bird_octave, slot, f.bird_octave),
        kf_bird_kp_valid=_set_row(m.kf_bird_kp_valid, slot, f.bird_kp_valid),
        kf_mp=_set_row(m.kf_mp, slot, -1),
        kf_bird_mp=_set_row(m.kf_bird_mp, slot, -1),
        n_kf=torch.clamp(m.n_kf, min=slot + 1),
        kf_counter=m.kf_counter + 1,
    )


def free_kf_slot(m: ms.MapState):
    """The first free keyframe slot, whether one exists, and how many are free
    (0-d tensors).  Culled slots are handed out again."""
    free = ~m.kf_valid
    slot = torch.argmax(free.to(torch.int32)).to(torch.int32)
    return slot, torch.any(free), torch.sum(free.to(torch.int32)).to(torch.int32)


def insert_keyframe(m: ms.MapState, f: Frame, assoc: TrackObs, Tcw, cfg: SystemConfig,
                    frame_id, slot=None, device=None) -> ms.MapState:
    """``CreateNewKeyFrame`` (``Tracking.cc:1542-1620``): write the keyframe,
    register the frame's map-point associations as observations, and create
    bird points from its unmatched bird keypoints (``CreateBirdPoints``,
    ``:1622-1682``).  ``slot`` defaults to the first free slot (one host
    read); callers make sure one exists."""
    dev = resolve_device(device)
    m, f, assoc = to_device(m, dev), to_device(f, dev), to_device(assoc, dev)
    Tcw = Tcw.to(dev)
    slot = int(free_kf_slot(m)[0] if slot is None else slot)
    m = _write_kf(m, slot, f, Tcw, False, frame_id)
    F = f.uv.shape[0]
    FB = f.bird_uv.shape[0]
    P = m.mp_pos.shape[0]
    PB = m.bp_pos.shape[0]
    i32 = torch.int32
    slot_t = _slot_tensor(slot, dev)

    pid = assoc.mp_idx.clamp(0, P - 1)
    fok = (assoc.mp_idx >= 0) & f.kp_valid & m.mp_valid[pid.long()]
    feats = torch.arange(F, dtype=i32, device=dev)
    m = m._replace(kf_mp=_set_row(m.kf_mp, slot, torch.where(fok, assoc.mp_idx, -1)))
    m = ms.add_observation(m, pid, slot_t, feats, fok)
    m = m._replace(mp_found=m.mp_found.index_add(0, torch.where(fok, pid, P - 1).long(),
                                                 fok.to(i32)))
    if not cfg.flags.have_bird:
        return m

    bid = assoc.bp_idx.clamp(0, PB - 1)
    bok = (assoc.bp_idx >= 0) & f.bird_kp_valid & m.bp_valid[bid.long()]
    bfeats = torch.arange(FB, dtype=i32, device=dev)
    m = ms.add_bird_observation(m, bid, slot_t, bfeats, bok)
    new_bird = f.bird_kp_valid & (assoc.bp_idx < 0)
    bp_world = se3.transform(se3.inverse(Tcw), f.bird_cam)
    dest, can = ms.alloc_slots(m.bp_valid, new_bird)
    m = ms.reset_bird_slots(m, dest, can)
    put = functools.partial(ms.put_rows, idx=dest, ok=can)
    m = m._replace(
        bp_pos=put(m.bp_pos, values=bp_world),
        bp_desc=put(m.bp_desc, values=f.bird_desc),
        bp_desc_pm1=put(m.bp_desc_pm1, values=f.bird_desc_pm1),
        bp_valid=put(m.bp_valid, values=torch.ones_like(can)),
        bp_ref_kf=put(m.bp_ref_kf, values=slot_t.expand(FB)),
        bp_birth=put(m.bp_birth, values=m.kf_seq[slot].expand(FB)),
        n_bp=m.n_bp + torch.sum(can.to(i32)).to(i32),
        kf_bird_mp=_set_row(m.kf_bird_mp, slot,
                            torch.where(bok, assoc.bp_idx, torch.where(can, dest, -1))),
    )
    return ms.add_bird_observation(m, dest, slot_t, bfeats, can)


def odom_chain_edges(m: ms.MapState, cfg: SystemConfig, member_mask) -> OdomEdges:
    """Odometry SE3 edges between temporally consecutive members of
    ``member_mask`` (chain, and skip-1 / skip-2 under ``tight_couple2``), in
    insertion order so recycled slots chain correctly.  Without
    ``tight_couple`` the edges exist but are all invalid (``Optimizer.cc:2419``)."""
    ba, flags = cfg.ba, cfg.flags
    K = m.K
    dev = member_mask.device
    perm = ms.temporal_perm(m).long()
    specs = [(1, ba.odom_info_chain * ba.w_pose)]
    if flags.tight_couple2:
        specs += [(2, ba.odom_info_skip1), (3, ba.odom_info_skip2 * ba.w_pose)]
    ei = torch.cat([perm[:-skip] for skip, _ in specs])
    ej = torch.cat([perm[skip:] for skip, _ in specs])
    einfo = torch.cat([torch.full((K - skip,), info, dtype=torch.float32, device=dev)
                       for skip, info in specs])
    ev = member_mask[ei] & member_mask[ej] & m.kf_valid[ei] & m.kf_valid[ej]
    if not flags.tight_couple:
        ev = torch.zeros_like(ev)
    T_meas = odo.preintegrate_cam(cfg.extrinsics, m.kf_odom[ei], m.kf_odom[ej])
    return OdomEdges(ei.to(torch.int32), ej.to(torch.int32), T_meas, einfo, ev)


def _epipolar_line_dist(cam, Tcw1, Tcw2, uv1, uv2):
    """(F1, F2) squared distance of each uv2 to the epipolar line of each uv1
    (``CheckDistEpipolarLine``, ``ORBmatcher.cc:658-823``)."""
    T12 = se3.compose(Tcw1, se3.inverse(Tcw2))          # cam2 -> cam1
    R12 = se3.quat_to_matrix(T12[:4])
    tx = se3.skew(T12[4:])
    Kinv = const(((1.0 / cam.fx, 0.0, -cam.cx / cam.fx), (0.0, 1.0 / cam.fy, -cam.cy / cam.fy),
                  (0.0, 0.0, 1.0)), torch.float32, Tcw1.device)
    F12 = Kinv.T @ tx @ R12 @ Kinv                       # x1^T F12 x2 = 0
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=-1)
    lines = x1 @ F12                                     # epipolar lines in image 2
    num = torch.abs(lines @ x2.T)
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    return num * num / torch.clamp(den2[:, None], min=1e-12)


def triangulate_new_points(m: ms.MapState, new_kf: int, ref_kf: int,
                           cfg: SystemConfig) -> ms.MapState:
    """``LocalMapping::CreateNewMapPoints`` (``LocalMapping.cc:231-476``)
    against one neighbour: match the new keyframe's unassociated features to
    the neighbour's (rotation-compensated 120 px window, epipolar gate, ratio
    0.8), triangulate, and allocate the accepted points."""
    F = m.kf_uv.shape[1]
    P = m.mp_pos.shape[0]
    cam = cfg.camera
    d1 = desc_pm1_from_packed(m.kf_desc[new_kf])
    d2 = desc_pm1_from_packed(m.kf_desc[ref_kf])
    un1 = m.kf_kp_valid[new_kf] & (m.kf_mp[new_kf] < 0)
    un2 = m.kf_kp_valid[ref_kf] & (m.kf_mp[ref_kf] < 0)
    # where each feature lands in the neighbour at infinite depth: K R K^-1
    R_rel = se3.quat_to_matrix(m.kf_Tcw[ref_kf, :4]) @ se3.quat_to_matrix(m.kf_Tcw[new_kf, :4]).T
    uv1 = m.kf_uv[new_kf]
    rays = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy,
                        torch.ones_like(uv1[:, 0])], dim=-1) @ R_rel.T
    z = torch.where(torch.abs(rays[:, 2]) < 1e-6, 1e-6, rays[:, 2])
    uv_pred = torch.stack([cam.fx * rays[:, 0] / z + cam.cx,
                           cam.fy * rays[:, 1] / z + cam.cy], dim=-1)
    compat = matcher.window_mask(uv_pred, m.kf_uv[ref_kf], 120.0)
    compat = compat & un1[:, None] & un2[None, :] & (rays[:, 2] > 0)[:, None]
    lut = inv_level_sigma2_lut(cfg, uv1.device)
    sigma2_ref = 1.0 / lut[m.kf_octave[ref_kf].clamp(0, lut.shape[0] - 1).long()]
    ep2 = _epipolar_line_dist(cam, m.kf_Tcw[new_kf], m.kf_Tcw[ref_kf], uv1, m.kf_uv[ref_kf])
    compat = compat & (ep2 < 3.84 * sigma2_ref[None, :])
    res = matcher.match(d1, d2, compat, max_dist=float(cfg.matcher.th_low), ratio=0.8)
    res = matcher.resolve_duplicates(res, F)
    f2 = res.idx.clamp(0, F - 1)
    tri = triangulate(cam, m.kf_Tcw[new_kf], m.kf_Tcw[ref_kf], uv1,
                      m.kf_uv[ref_kf][f2.long()], max_reproj_err=5.991,
                      min_parallax_cos=0.9998)
    dest, can = ms.alloc_slots(m.mp_valid, res.ok & tri.valid)
    m = ms.reset_point_slots(m, dest, can, m.kf_seq[new_kf])
    put = functools.partial(ms.put_rows, idx=dest, ok=can)
    kf_mp = m.kf_mp.clone()
    kf_mp[new_kf] = torch.where(can, dest, m.kf_mp[new_kf])
    kf_mp[ref_kf] = ms.put_rows(m.kf_mp[ref_kf], f2, can, dest)
    m = m._replace(
        mp_pos=put(m.mp_pos, values=tri.Xw),
        mp_desc=put(m.mp_desc, values=m.kf_desc[new_kf]),
        mp_desc_pm1=put(m.mp_desc_pm1, values=d1),
        mp_valid=put(m.mp_valid, values=torch.ones_like(can)),
        mp_ref_kf=put(m.mp_ref_kf, values=torch.full((F,), new_kf, dtype=torch.int32,
                                                     device=can.device)),
        n_mp=m.n_mp + torch.sum(can.to(torch.int32)).to(torch.int32),
        kf_mp=kf_mp,
    )
    feats = torch.arange(F, dtype=torch.int32, device=can.device)
    m = ms.add_observation(m, dest, _slot_tensor(new_kf, can.device), feats, can)
    return ms.add_observation(m, dest, _slot_tensor(ref_kf, can.device), f2, can)


def _mask_lookup(mask_k, idx):
    """``mask_k[idx]`` for keyframe indices, out-of-range ones clamped."""
    return mask_k[idx.clamp(0, mask_k.shape[0] - 1).long()]


def _local_window_masks(m: ms.MapState, cfg: SystemConfig, center_kf: int):
    """The covisibility window of ``center_kf``: (is_local (K,), local_idx
    (L,), pt_in (P,), bpt_in (PB,), n_lobs (P,), bn_lobs (PB,), c_obs (P,),
    bc_obs (PB,)): the keyframes the local BA optimises, the landmarks they
    observe, how many local observations each has and whether the centre
    keyframe is one of them."""
    K = m.K
    dev = m.kf_valid.device
    C = ms.covisibility_counts(m)
    w = torch.where(m.kf_valid, C[center_kf], -1)
    w[center_kf] = torch.iinfo(torch.int32).max
    _, local_idx = _topk_stable(w, min(cfg.capacity.max_local_kfs, K))
    is_local = torch.zeros(K, dtype=torch.bool, device=dev)
    is_local[local_idx] = True
    is_local = is_local & m.kf_valid & (w > 0)
    is_local[center_kf] = True
    n_lobs = torch.sum((_mask_lookup(is_local, m.obs_kf) & m.obs_valid).to(torch.int32), dim=1)
    bn_lobs = torch.sum((_mask_lookup(is_local, m.bobs_kf) & m.bobs_valid).to(torch.int32), dim=1)
    c_obs = torch.any((m.obs_kf == center_kf) & m.obs_valid, dim=1)
    bc_obs = torch.any((m.bobs_kf == center_kf) & m.bobs_valid, dim=1)
    return (is_local, local_idx.to(torch.int32), (n_lobs > 0) & m.mp_valid,
            (bn_lobs > 0) & m.bp_valid, n_lobs, bn_lobs, c_obs, bc_obs)


def _priority_packed_select(in_mask, n_lobs, center_obs, cap: int):
    """The first ``cap`` landmark slots by constraint strength: in the window
    first, seen by the centre keyframe first, then most local observations,
    then index, by one sort of packed (priority, index) keys.  Returns
    (sel (cap,) int32, valid (cap,) bool)."""
    N = in_mask.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=in_mask.device)
    prio = torch.where(in_mask, (~center_obs).to(torch.int32) * 256
                       + torch.clamp(256 - n_lobs, 0, 255), 1023)
    sel = (torch.sort(prio * N + idx).values[:cap] % N).to(torch.int32)
    return sel, in_mask[sel.long()]


def local_ba_truncation(m: ms.MapState, cfg: SystemConfig, center_kf: int):
    """(front points dropped, bird points dropped, front points in the window,
    bird points in the window): the window's landmarks beyond
    ``max_local_points`` / ``max_local_bird_points`` that ``local_ba`` leaves out."""
    cap = cfg.capacity
    _, _, pt_in, bpt_in = _local_window_masks(m, cfg, center_kf)[:4]
    n_pt = torch.sum(pt_in.to(torch.int32))
    n_bpt = torch.sum(bpt_in.to(torch.int32))
    PL = min(cap.max_local_points, m.mp_pos.shape[0])
    PBL = min(cap.max_local_bird_points, m.bp_pos.shape[0])
    return torch.stack([torch.clamp(n_pt - PL, min=0), torch.clamp(n_bpt - PBL, min=0),
                        n_pt, n_bpt])


def _blocks(lut, pos, sel, pval, obs_kf, obs_feat, obs_valid, inv, LC: int, meas, octave):
    """PointBlocks of the landmarks ``sel`` in the compact keyframe space."""
    s = sel.long()
    okf, ofeat = obs_kf[s].long(), obs_feat[s].long()
    kf_c = inv[okf]
    valid_c = obs_valid[s] & (kf_c < LC)
    oct_ = octave[okf, ofeat].clamp(0, lut.shape[0] - 1).long()
    return PointBlocks(Xw=pos[s], kf_idx=kf_c.clamp(0, LC), meas=meas[okf, ofeat],
                       inv_sigma2=lut[oct_], valid=valid_c, point_valid=pval)


def local_ba(m: ms.MapState, cfg: SystemConfig, center_kf: int) -> ms.MapState:
    """``LocalBundleAdjustmentWithOdom`` (``Optimizer.cc:2137-2495``) over the
    covisibility window of ``center_kf``: window keyframes optimised (``isInit``
    ones fixed), the other observers fixed, front, bird and odometry factors.
    The problem is compacted first to ``max_local_kfs`` + ``max_local_observers``
    keyframes (+ a fixed dummy) and ``max_local_points`` /
    ``max_local_bird_points`` landmarks, the strongest first.  Results are
    written back to the selected rows only: a padding row of the landmark
    selection (a window under the cap) names a landmark outside the window,
    whose observations keep their flags (ROADMAP, queue 3)."""
    cap = cfg.capacity
    K = m.K
    dev = m.kf_valid.device
    (is_local, local_idx, pt_in, bpt_in,
     n_lobs, bn_lobs, c_obs, bc_obs) = _local_window_masks(m, cfg, center_kf)
    L = local_idx.shape[0]
    obs_cnt = torch.zeros(K, dtype=torch.int32, device=dev).index_add(
        0, m.obs_kf.reshape(-1).long(), (m.obs_valid & pt_in[:, None]).reshape(-1).to(torch.int32))
    observer = (obs_cnt > 0) & m.kf_valid
    fixed_full = (observer & ~is_local) | (is_local & m.kf_is_init)

    O = min(cap.max_local_observers, K)
    LC = L + O
    obs_rank = torch.where(observer & ~is_local, obs_cnt, -1)
    ranks, obs_idx = _topk_stable(obs_rank, O)
    sel = torch.cat([local_idx, obs_idx.to(torch.int32)])
    sel_ok = torch.cat([is_local[local_idx.long()], ranks > 0])
    arange_lc = torch.arange(LC, dtype=torch.int32, device=dev)
    inv = ms.put_rows(torch.full((K,), LC, dtype=torch.int32, device=dev), sel, sel_ok, arange_lc)
    s = sel.long()
    poses_c = torch.cat([m.kf_Tcw[s], se3.identity(device=dev)[None]])
    fixed_c = torch.cat([fixed_full[s] | ~sel_ok, torch.ones(1, dtype=torch.bool, device=dev)])

    lut = inv_level_sigma2_lut(cfg, dev)
    psel, pval = _priority_packed_select(pt_in, n_lobs, c_obs,
                                         min(cap.max_local_points, m.mp_pos.shape[0]))
    front = _blocks(lut, m.mp_pos, psel, pval, m.obs_kf, m.obs_feat, m.obs_valid, inv, LC,
                    m.kf_uv, m.kf_octave)
    bsel, bval = _priority_packed_select(bpt_in, bn_lobs, bc_obs,
                                         min(cap.max_local_bird_points, m.bp_pos.shape[0]))
    bird = _blocks(lut, m.bp_pos, bsel, bval, m.bobs_kf, m.bobs_feat, m.bobs_valid, inv, LC,
                   m.kf_bird_cam, m.kf_bird_octave)
    oe = odom_chain_edges(m, cfg, is_local)
    ei_c, ej_c = inv[oe.i.long()], inv[oe.j.long()]
    odom_edges = OdomEdges(ei_c.clamp(0, LC), ej_c.clamp(0, LC), oe.T_meas, oe.info,
                           oe.valid & (ei_c < LC) & (ej_c < LC))

    out = bundle_adjust(cfg.camera, cfg.ba, poses_c, fixed_c, front, bird, odom_edges)
    upd_kf = sel_ok & ~fixed_full[s]
    ps, bs = psel.long(), bsel.long()
    return m._replace(
        kf_Tcw=ms.put_rows(m.kf_Tcw, sel, upd_kf, out.poses[:LC]),
        mp_pos=ms.put_rows(m.mp_pos, psel, pval, out.front_Xw),
        bp_pos=ms.put_rows(m.bp_pos, bsel, bval, out.bird_Xw),
        obs_valid=m.obs_valid.index_copy(
            0, ps, torch.where(front.valid & pval[:, None], out.front_inlier, m.obs_valid[ps])),
        bobs_valid=m.bobs_valid.index_copy(
            0, bs, torch.where(bird.valid & bval[:, None], out.bird_inlier, m.bobs_valid[bs])),
    )


def fuse_neighbors(m: ms.MapState, new_kf: int, neighbor_kf: int,
                   cfg: SystemConfig) -> ms.MapState:
    """``LocalMapping::SearchInNeighbors`` (``LocalMapping.cc:478-558``) in one
    direction: project the new keyframe's points into the neighbour and match
    in a 4 px window.  A match on a free feature registers the observation; a
    match on a feature holding another point merges the two
    (``MapPoint::Replace``, ``MapPoint.cc:177``): the one with fewer
    observations is redirected to the other in every ``kf_mp`` entry and
    retired.  A point that is the loser of more than one merge is left alone."""
    F = m.kf_uv.shape[1]
    P = m.mp_pos.shape[0]
    dev = m.kf_valid.device
    i32 = torch.int32
    row = m.kf_mp[new_kf]
    pid = row.clamp(0, P - 1)
    pl = pid.long()
    has_pt = (row >= 0) & m.mp_valid[pl]
    pc = se3.transform(m.kf_Tcw[neighbor_kf], m.mp_pos[pl])
    uv_proj = cam_ops.project_pinhole(cfg.camera, pc)
    vis = has_pt & (pc[:, 2] > 0.1)
    compat = matcher.window_mask(uv_proj, m.kf_uv[neighbor_kf], 4.0)
    compat = compat & vis[:, None] & m.kf_kp_valid[neighbor_kf][None, :]
    res = matcher.match(m.mp_desc_pm1[pl], desc_pm1_from_packed(m.kf_desc[neighbor_kf]), compat,
                        max_dist=float(cfg.matcher.th_low))
    res = matcher.resolve_duplicates(res, F)
    ok = res.ok & vis
    feat_nb = res.idx.clamp(0, F - 1)
    nb_pt = m.kf_mp[neighbor_kf][feat_nb.long()]
    free_hit = ok & (nb_pt < 0)
    dup_hit = ok & (nb_pt >= 0) & (nb_pt != pid)
    nb_t = _slot_tensor(neighbor_kf, dev)

    m = ms.add_observation(m, pid, nb_t, feat_nb, free_hit)
    m = m._replace(kf_mp=_set_row(m.kf_mp, neighbor_kf,
                                  ms.put_rows(m.kf_mp[neighbor_kf], feat_nb, free_hit, pid)))

    nobs = ms.point_obs_count(m)
    a, b = pid, nb_pt.clamp(0, P - 1)
    a_wins = nobs[a.long()] >= nobs[b.long()]
    winner = torch.where(a_wins, a, b)
    loser = torch.where(a_wins, b, a)
    do_merge = dup_hit & m.mp_valid[a.long()] & m.mp_valid[b.long()]
    # redirect table: applied only where exactly one merge names the loser
    mf = do_merge.to(i32)
    tgt = torch.where(do_merge, loser, 0).long()
    cnt = torch.zeros(P, dtype=i32, device=dev).index_add(0, tgt, mf)
    wsum = torch.zeros(P, dtype=i32, device=dev).index_add(0, tgt, winner * mf)
    unique = cnt == 1
    redirect = torch.where(unique, wsum, torch.arange(P, dtype=i32, device=dev))
    do_merge = do_merge & unique[loser.long()]
    kf_mp = torch.where(m.kf_mp >= 0, redirect[m.kf_mp.clamp(0, P - 1).long()], -1)
    lose_mask = ms.put_rows(torch.zeros(P, dtype=torch.bool, device=dev), loser, do_merge,
                            torch.ones_like(do_merge))
    mp_valid = m.mp_valid & ~lose_mask
    m = m._replace(kf_mp=kf_mp, mp_valid=mp_valid, obs_valid=m.obs_valid & mp_valid[:, None])
    # the winner gains the neighbour's feature when it was the new keyframe's point
    return ms.add_observation(m, winner, nb_t, feat_nb, do_merge & a_wins)


def _top_covis_neighbors(m: ms.MapState, new_kf: int, n_neighbors: int):
    """The ``n_neighbors`` most covisible keyframes of ``new_kf``
    (``GetBestCovisibilityKeyFrames``), equal weights in slot order: (slots
    (N,) int32, valid (N,) bool), a neighbour needing one shared point."""
    K = m.K
    dev = m.kf_valid.device
    C = ms.covisibility_counts(m)
    w = torch.where(m.kf_valid & (torch.arange(K, device=dev) != new_kf), C[new_kf], -1)
    k = min(n_neighbors, K)
    ww, nb = _topk_stable(w, k)
    pad = n_neighbors - k
    if pad:
        nb = torch.cat([nb, torch.zeros(pad, dtype=nb.dtype, device=dev)])
        ww = torch.cat([ww, torch.full((pad,), -1, dtype=ww.dtype, device=dev)])
    return nb.to(torch.int32), ww > 0


def _enabled_neighbors(m: ms.MapState, new_kf: int, n_neighbors: int):
    """The enabled neighbours as host integers, best first (one host read)."""
    nb, ok = _top_covis_neighbors(m, new_kf, n_neighbors)
    slots, oks = torch.stack([nb, ok.to(torch.int32)]).tolist()
    return [s for s, o in zip(slots, oks) if o], len(slots)


def local_mapping_triangulate(m: ms.MapState, new_kf: int, cfg: SystemConfig,
                              n_neighbors: int) -> ms.MapState:
    """``CreateNewMapPoints`` over the top covisible neighbours, best first;
    a feature matched against one neighbour is no longer free for the next.
    A disabled neighbour changes nothing (every write is gated by its match),
    so only the enabled ones run."""
    for nb in _enabled_neighbors(m, new_kf, n_neighbors)[0]:
        m = triangulate_new_points(m, new_kf, nb, cfg)
    return m


def local_mapping_fuse(m: ms.MapState, new_kf: int, cfg: SystemConfig,
                       n_neighbors: int) -> ms.MapState:
    """``SearchInNeighbors`` over the top covisible neighbours, both directions
    (the new keyframe's points into each neighbour, then the neighbour's into
    the new keyframe).  A disabled neighbour's only effect is to drop the
    observations of retired points, which is applied in its place."""
    nbs, n = _enabled_neighbors(m, new_kf, n_neighbors)
    for nb in nbs:
        m = fuse_neighbors(m, new_kf, nb, cfg)
        m = fuse_neighbors(m, nb, new_kf, cfg)
    if len(nbs) < n:
        m = m._replace(obs_valid=m.obs_valid & m.mp_valid[:, None])
    return m


def relieve_point_pressure(m: ms.MapState, cfg: SystemConfig, center_kf: int) -> ms.MapState:
    """Landmark eviction under capacity pressure: when fewer than 1/16 of the
    slots are free, retire the eighth of the landmarks outside the covisibility
    window of ``center_kf`` with the fewest observations, oldest first."""
    _, _, pt_in, bpt_in = _local_window_masks(m, cfg, center_kf)[:4]

    def relieve(valid, in_window, nobs, birth):
        n = valid.shape[0]
        need = torch.sum((~valid).to(torch.int32)) < n // 16
        evictable = valid & ~in_window
        score = torch.where(evictable, nobs.to(torch.float32) * 1e6 + birth.to(torch.float32),
                            torch.inf)
        k = n // 8
        kth = torch.sort(score).values[k - 1]
        return valid & ~(evictable & (score <= kth) & need)

    mp_valid = relieve(m.mp_valid, pt_in, ms.point_obs_count(m), m.mp_first_kf)
    bnobs = torch.sum((m.bobs_valid & m.bp_valid[:, None]).to(torch.int32), dim=1)
    bp_valid = relieve(m.bp_valid, bpt_in, bnobs, m.bp_birth)
    n_evicted = (torch.sum((m.mp_valid & ~mp_valid).to(torch.int32))
                 + torch.sum((m.bp_valid & ~bp_valid).to(torch.int32)))
    m = m._replace(mp_valid=mp_valid, bp_valid=bp_valid,
                   obs_valid=m.obs_valid & mp_valid[:, None],
                   bobs_valid=m.bobs_valid & bp_valid[:, None],
                   n_pressure_evicted=(m.n_pressure_evicted + n_evicted).to(torch.int32))
    return ms.scrub_stale_refs(m)


def update_point_stats(m: ms.MapState, cfg: SystemConfig) -> ms.MapState:
    """``MapPoint::ComputeDistinctiveDescriptors`` + ``UpdateNormalAndDepth``
    (``MapPoint.cc:242,330-399``): the descriptor becomes the observation
    descriptor with the least median Hamming distance to the others, the
    normal the mean viewing direction, and the scale range follows the
    reference keyframe's observation."""
    P, M = m.obs_kf.shape
    K = m.K
    v = m.obs_valid & m.mp_valid[:, None]
    okf, ofeat = m.obs_kf.clamp(0, K - 1).long(), m.obs_feat.long()
    desc = m.kf_desc[okf, ofeat]                                     # (P, M, 8)
    d = torch.zeros((P, M, M), dtype=torch.int32, device=desc.device)
    for w in range(desc.shape[-1]):
        d += cuda_matcher.popcount32(torch.bitwise_xor(desc[:, :, None, w], desc[:, None, :, w]))
    d = torch.where(v[:, :, None] & v[:, None, :], d, 1 << 14)
    nv = torch.sum(v.to(torch.int32), dim=-1)
    k = torch.clamp(nv // 2, 0, M - 1).long()
    med = torch.gather(torch.sort(d, dim=-1).values, 2, k[:, None, None].expand(P, M, 1))[..., 0]
    med = torch.where(v, med, 1 << 15)
    rows = torch.arange(P, device=desc.device)
    new_desc = desc[rows, torch.argmin(med, dim=-1)]
    has_obs = nv > 0
    Twc = se3.inverse(m.kf_Tcw)
    rays = m.mp_pos[:, None, :] - Twc[okf][..., 4:]
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(v[..., None], rays, 0.0), dim=1)
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-9)
    ref = m.mp_ref_kf.clamp(0, K - 1).long()
    dist_ref = torch.linalg.vector_norm(m.mp_pos - Twc[ref][:, 4:], dim=-1)
    is_ref = (m.obs_kf == ref[:, None]) & v
    slot = torch.where(torch.any(is_ref, dim=1), torch.argmax(is_ref.to(torch.int32), dim=1),
                       torch.argmax(v.to(torch.int32), dim=1))
    oct_ref = m.kf_octave[okf[rows, slot], ofeat[rows, slot]]
    sf = cfg.orb.scale_factor
    max_dist = dist_ref * torch.exp(oct_ref.to(torch.float32) * math.log(sf))
    min_dist = max_dist / (sf ** (cfg.orb.n_levels - 1))
    col = has_obs[:, None]
    return m._replace(
        mp_desc=torch.where(col, new_desc, m.mp_desc),
        mp_desc_pm1=torch.where(col, desc_pm1_from_packed(new_desc), m.mp_desc_pm1),
        mp_normal=torch.where(col, normal, m.mp_normal),
        mp_min_dist=torch.where(has_obs, min_dist, m.mp_min_dist),
        mp_max_dist=torch.where(has_obs, max_dist, m.mp_max_dist),
    )


def cull_points(m: ms.MapState, cfg: SystemConfig) -> ms.MapState:
    """``MapPointCulling`` (``LocalMapping.cc:194-229``): drop points found in
    fewer than a quarter of the frames that saw them, and points with fewer
    than 2 observations two keyframes after their birth."""
    ratio = m.mp_found.to(torch.float32) / torch.clamp(m.mp_visible.to(torch.float32), min=1.0)
    mature = (m.kf_counter - 1 - m.mp_first_kf) >= 2
    keep = m.mp_valid & (ratio >= 0.25) & (~mature | (ms.point_obs_count(m) >= 2))
    return ms.scrub_stale_refs(m._replace(mp_valid=keep, obs_valid=m.obs_valid & keep[:, None]))


def _drop_keyframes(m: ms.MapState, keep) -> ms.MapState:
    K = m.K
    return m._replace(kf_valid=keep, kf_seq=torch.where(keep, m.kf_seq, -1),
                      obs_valid=m.obs_valid & _mask_lookup(keep, m.obs_kf),
                      bobs_valid=m.bobs_valid & _mask_lookup(keep, m.bobs_kf))


def cull_keyframes(m: ms.MapState, cfg: SystemConfig) -> ms.MapState:
    """``LocalMapping::KeyFrameCulling`` (``LocalMapping.cc:656-729``): retire
    at most one keyframe whose tracked points are >= 90% seen by 3 other
    keyframes; the first two, the 3 newest and ``isInit`` keyframes are kept."""
    K = m.K
    P = m.mp_pos.shape[0]
    nobs = ms.point_obs_count(m)
    pid = m.kf_mp.clamp(0, P - 1).long()
    tracked = (m.kf_mp >= 0) & m.mp_valid[pid]
    n_tracked = torch.sum(tracked.to(torch.int32), dim=1)
    n_red = torch.sum((tracked & (nobs[pid] >= 4)).to(torch.int32), dim=1)
    frac = n_red / torch.clamp(n_tracked, min=1)
    cullable = m.kf_valid & (frac > 0.9) & (n_tracked > 10) & (m.kf_seq >= 2) \
        & (m.kf_seq < m.kf_counter - 3) & ~m.kf_is_init
    worst = torch.argmax(torch.where(cullable, frac, -1.0))
    cullable = cullable & (torch.arange(K, device=worst.device) == worst)
    return ms.reassign_orphan_refs(_drop_keyframes(m, m.kf_valid & ~cullable))


def force_evict_keyframe(m: ms.MapState, cfg: SystemConfig) -> ms.MapState:
    """Keyframe eviction under capacity pressure: with every slot live, retire
    the eligible keyframe with the weakest covisibility ties (the oldest among
    equals); the first two, ``isInit`` ones and the 5 newest are kept."""
    K = m.K
    C = ms.covisibility_counts(m) + ms.bird_covisibility_counts(m)
    ties = torch.sum(torch.where(m.kf_valid[None, :], C, 0), dim=1)
    eligible = m.kf_valid & (m.kf_seq >= 2) & (m.kf_seq < m.kf_counter - 5) & ~m.kf_is_init
    score = ties.to(torch.float32) * float(K) + m.kf_seq.to(torch.float32) / float(1 << 20)
    victim = torch.argmin(torch.where(eligible, score, torch.inf))
    evict = eligible & (torch.arange(K, device=victim.device) == victim)
    return ms.reassign_orphan_refs(ms.scrub_stale_refs(_drop_keyframes(m, m.kf_valid & ~evict)))


def need_new_keyframe(cfg: SystemConfig, *, localization_only: bool, n_kfs: int, frame_id: int,
                      last_kf_frame_id: int, last_reloc_frame_id: int, n_inliers: int,
                      n_ref_matches: int, mapping_idle: bool, n_bird_matched: int = 0,
                      n_ref_bird: int = 0):
    """``Tracking::NeedNewKeyFrame`` (``Tracking.cc:1444-1540``) as a host
    decision: returns ``(need, interrupt_ba)``.  Insert when (max frames since
    the last keyframe, or min frames and mapping idle) and inliers < 0.9 x the
    reference keyframe's points and > 15, if mapping is idle; otherwise ask
    for an InterruptBA.  Refused in localization-only mode and within max
    frames of a relocalisation once the map has more than max frames
    keyframes.  The bird trigger (matched bird points < 0.35 x the reference
    keyframe's) is left out of the decision, as the reference leaves it."""
    if localization_only:
        return False, False
    max_frames = int(cfg.tracking.max_frames_between_kf)
    min_frames = int(cfg.tracking.min_frames_between_kf)
    if frame_id < last_reloc_frame_id + max_frames and n_kfs > max_frames:
        return False, False
    c1a = frame_id >= last_kf_frame_id + max_frames
    c1b = frame_id >= last_kf_frame_id + max(1, min_frames) and mapping_idle
    c2 = n_inliers < n_ref_matches * 0.9 and n_inliers > 15
    if (c1a or c1b) and c2:
        return (True, False) if mapping_idle else (False, True)
    return False, False


def local_mapping_pre(m: ms.MapState, new_kf: int, cfg: SystemConfig, n_neighbors: int,
                      device=None, counts: dict | None = None) -> ms.MapState:
    """The mapping stages before local BA: point-pressure relief, triangulation,
    fusion, point culls and landmark statistics.  With ``counts`` (a dict), it
    receives 0-d tensors, read by the caller when it likes: front points
    ``evicted``, ``created``, ``merged`` and ``culled``, bird points ``bird_culled``."""
    m = to_device(m, resolve_device(device))
    n = lambda valid: torch.sum(valid.to(torch.int32))
    stages = {}
    n0 = n(m.mp_valid)
    if cfg.tracking.point_pressure_valve:
        m = relieve_point_pressure(m, cfg, new_kf)
    stages["evicted"] = n0 - n(m.mp_valid)
    n1 = m.n_mp
    m = local_mapping_triangulate(m, new_kf, cfg, n_neighbors)
    stages["created"] = m.n_mp - n1
    n2 = n(m.mp_valid)
    m = local_mapping_fuse(m, new_kf, cfg, n_neighbors)
    stages["merged"] = n2 - n(m.mp_valid)
    n3, nb3 = n(m.mp_valid), n(m.bp_valid)
    m = cull_points(m, cfg)
    m = cull_bird_points(m, cfg, m.kf_Tcw[new_kf])
    stages["culled"], stages["bird_culled"] = n3 - n(m.mp_valid), nb3 - n(m.bp_valid)
    if counts is not None:
        counts.update(stages)
    return update_point_stats(m, cfg)


def local_mapping_ba(m: ms.MapState, new_kf: int, cfg: SystemConfig, device=None) -> ms.MapState:
    """Local BA, then keyframe culling."""
    m = to_device(m, resolve_device(device))
    return cull_keyframes(local_ba(m, cfg, new_kf), cfg)


def local_mapping_step(m: ms.MapState, new_kf: int, cfg: SystemConfig, n_neighbors: int,
                       device=None) -> ms.MapState:
    """One ``LocalMapping::Run`` iteration for the keyframe in slot ``new_kf``
    (``LocalMapping.cc:51-130``): ``local_mapping_pre`` then ``local_mapping_ba``.
    Runs on ``device`` (the current CUDA card by default)."""
    dev = resolve_device(device)
    m = local_mapping_pre(m, new_kf, cfg, n_neighbors, dev)
    return local_mapping_ba(m, new_kf, cfg, dev)
