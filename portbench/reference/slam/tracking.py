# Frozen copy of fishbirdeyevisualslam_torch/slam/tracking.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""The tracking core and local mapping, cut to what the check runs:
``_track_frame_core`` and its callees (``TrackWithMotionModel``,
``TrackLocalMap``, the bird matching and per-frame bird maintenance of
``src/Tracking.cc``) and ``local_mapping_step`` (``LocalMapping.cc``:
triangulation, fusion, culls, landmark statistics, local BA).

One route, the port's plain one: the projection matches through the dense
``matcher.match`` (the port's fused matcher kernels and their candidate
compaction give the same results by construction), the pose optimisations
through the plain LM (``solvers/cuda_pose_opt.py``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from portbench.reference.config import SystemConfig
from portbench.reference.device import const, resolve_device, to_device
from portbench.reference.geometry import camera as cam_ops
from portbench.reference.geometry import ipm
from portbench.reference.geometry import odometry as odo
from portbench.reference.geometry import se3
from portbench.reference.ops import cuda_matcher, matcher
from portbench.reference.slam import map_state as ms
from portbench.reference.slam.frame import Frame, desc_pm1_from_packed, inv_level_sigma2_lut
from portbench.reference.solvers import cuda_pose_opt
from portbench.reference.solvers.ba import OdomEdges, PointBlocks, bundle_adjust
from portbench.reference.solvers.pose_opt import BirdObs, FrontObs
from portbench.reference.solvers.triangulate import triangulate

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


def match_map_points_dual_ids(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_ids,
                              radius: float, max_dist: float):
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
    res1, res2 = (
        _remap(matcher.match(f.desc_pm1, m.mp_desc_pm1[sel],
                             _dense_compat(f, uv_proj, r, pred, est, vis, cfg),
                             max_dist=max_dist), sel)
        for r in (r_pt, 2.0 * r_pt))
    return matcher.resolve_duplicates(res1, P), matcher.resolve_duplicates(res2, P)


def match_map_points(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_mask,
                     radius: float, max_dist: float, frustum_gates: bool):
    """``SearchByProjection`` against the local map (``ORBmatcher.cc:46``):
    project the candidates, search a window scaled by the predicted pyramid
    level, octave within one level of the prediction, and with
    ``frustum_gates`` the ``Frame::isInFrustum`` distance and viewing-angle
    checks.  Returns (MatchResult over features, vis (P,))."""
    uv_proj, vis, pred, est, r_scale = _project_front_gates(m, cfg, Tcw_pred, cand_mask,
                                                            frustum_gates)
    P = m.mp_pos.shape[0]
    r_pt = radius * r_scale
    res = matcher.match(f.desc_pm1, m.mp_desc_pm1,
                        _dense_compat(f, uv_proj, r_pt, pred, est, vis, cfg), max_dist=max_dist)
    return matcher.resolve_duplicates(res, P), vis


def _bird_vis(cfg: SystemConfig, Tcw_pred, pos, valid):
    """Predicted bird-image positions and the plane gate of bird points."""
    pc = se3.transform(Tcw_pred, pos)
    p_base = ipm.cam_xyz_to_base(cfg.extrinsics, pc)
    uv = ipm.base_xy_to_bird_pixel(cfg.bird, p_base)
    return uv, valid & (torch.abs(p_base[:, 2]) < cfg.bird.plane_gate)


def match_bird_points(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred,
                      cand_mask) -> matcher.MatchResult:
    """``BirdMapPointMatch`` (``ORBmatcher.cc:1763-1902``): project the bird
    points, match in a 30 px bird-image window, then gate coordinate-wise on
    the 3D camera-frame residual |d| < filter_gate_mult * filter_size."""
    PB = m.bp_pos.shape[0]
    th = float(cfg.matcher.th_high)
    uv, vis = _bird_vis(cfg, Tcw_pred, m.bp_pos, cand_mask & m.bp_valid)
    compat = matcher.window_mask(f.bird_uv, uv, 30.0)
    compat = compat & f.bird_kp_valid[:, None] & vis[None, :]
    res = matcher.match(f.bird_desc_pm1, m.bp_desc_pm1, compat, max_dist=th)
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


def _track_frame_core(m, f, cfg: SystemConfig, Tcw_pred, cand_last, ref_kf, last_f,
                      last_bp_idx, last_Tcw, bird_maint_enabled) -> TrackCoreOut:
    P = m.mp_pos.shape[0]
    FB = f.bird_uv.shape[0]
    th_high = float(cfg.matcher.th_high)
    res15, res30 = match_map_points_dual_ids(m, f, cfg, Tcw_pred, cand_last, 15.0, th_high)
    use30 = res15.count < cfg.tracking.min_track_matches
    res = matcher.MatchResult(*(torch.where(use30, b, a) for a, b in zip(res15, res30)))
    n_mm = res.count
    # the 5 m bird window is computed once, at the predicted pose, and reused
    # by the post-optimisation bird match
    if cfg.flags.have_bird:
        bwin = bird_local_mask(m, cfg, Tcw_pred)
        bres_idx = match_bird_points(m, f, cfg, Tcw_pred, bwin).idx
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
    res2, vis2 = match_map_points(m, f, cfg, Tcw1, pt_local, 12.0, th_high, True)
    mp_idx = torch.where(mp1 >= 0, mp1, res2.idx)
    if cfg.flags.have_bird:
        bres2_idx = match_bird_points(m, f, cfg, Tcw1, bwin).idx
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
