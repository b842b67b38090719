"""Per-frame tracking core — the port of the per-frame subset of
``fishbirdeyevisualslam_tpu/slam/tracking.py``: ``track_frame_core`` and its
callees (``TrackWithMotionModel``, ``TrackLocalMap`` and the bird matching of
``src/Tracking.cc``).

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

import math
from typing import NamedTuple

import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import const, resolve_device, to_device
from fishbirdeyevisualslam_torch.geometry import camera as cam_ops
from fishbirdeyevisualslam_torch.geometry import ipm
from fishbirdeyevisualslam_torch.geometry import odometry as odo
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.ops import cuda_matcher, matcher
from fishbirdeyevisualslam_torch.slam import map_state as ms
from fishbirdeyevisualslam_torch.slam.frame import Frame, inv_level_sigma2_lut
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs


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


def match_map_points(m: ms.MapState, f: Frame, cfg: SystemConfig, Tcw_pred, cand_mask,
                     radius: float, max_dist: float, frustum_gates: bool, fused: bool):
    """``SearchByProjection`` against the local map (``ORBmatcher.cc:46``):
    project the candidates, search a window scaled by the predicted pyramid
    level, octave within one level of the prediction, and with
    ``frustum_gates`` the ``Frame::isInFrustum`` distance and viewing-angle
    checks.  Returns (MatchResult over features, vis (P,))."""
    uv_proj, vis, pred, est, r_scale = _front_gates_arrays(
        cfg, Tcw_pred, m.mp_pos, m.mp_valid, m.mp_min_dist, m.mp_max_dist, m.mp_normal,
        cand_mask, frustum_gates)
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
