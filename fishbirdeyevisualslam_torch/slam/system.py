"""System facade — the port of ``fishbirdeyevisualslam_tpu/slam/system.py``
in its synchronous mode (the reference's ``System`` and the ``Tracking``
thread body, ``src/System.cc``, ``src/Tracking.cc:479-770``): the map state,
the NOT_INITIALIZED / OK state machine, two-view initialization, tracking,
the keyframe policy with insertion and local mapping run synchronously after
it, and the per-frame trajectory.

``SlamSystem.track`` is the entry point, one call per frame.  Everything runs
on ``device`` (the current CUDA card unless the caller names another).  A
frame's images and odometry reach the card in one non-blocking copy, and
the host reads of a tracked frame that inserts no keyframe are those of
``track_frame_core`` and one copy of the frame's counts, pose and record.

Not ported yet, and raising ``NotImplementedError`` where the JAX package
would take them: asynchronous mapping (ROADMAP queue 1 item 4), loop closing
and the ``TrackReferenceKeyFrame`` fallback after fewer than 10 motion-model
matches (item 5), and the LOST state's recovery (items 5 and 6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import resolve_device
from fishbirdeyevisualslam_torch.geometry import ipm, se3
from fishbirdeyevisualslam_torch.geometry import odometry as odo
from fishbirdeyevisualslam_torch.io.tracing import Tracer
from fishbirdeyevisualslam_torch.slam import map_state as ms
from fishbirdeyevisualslam_torch.slam import tracking as tr
from fishbirdeyevisualslam_torch.slam.frame import Frame, build_frame
from fishbirdeyevisualslam_torch.solvers import initializer as init_mod


@dataclasses.dataclass
class TrajectoryEntry:
    """A frame's pose stored relative to its reference keyframe, recomposed at
    export so that later BA corrections reach the whole trajectory
    (``Tracking.cc:752-768``, ``System.cc:384-470``)."""

    timestamp: float
    T_rel: np.ndarray         # (7,) Tcw_frame * inv(Tcw_refkf) at record time
    ref_kf: int               # keyframe slot (-1: absolute, before the map; -2: frozen at a reset)
    is_keyframe: bool
    state: int
    ref_frame_id: int = -1    # source frame id of the reference keyframe: slots recycle


def _np_compose(a, b) -> np.ndarray:
    return se3.compose(torch.as_tensor(a), torch.as_tensor(b)).numpy()


class SlamSystem:
    """``System::TrackMonocularWithOdom``: call ``track`` once per frame."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), localization_only: bool = False,
                 async_mapping: bool = False, device=None):
        if async_mapping:
            raise NotImplementedError(
                "async_mapping needs the native mapping pipeline, which is not ported yet "
                "(ROADMAP queue 1 item 4); use the synchronous mode")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.map: Optional[ms.MapState] = None
        self.state = tr.NOT_INITIALIZED
        self.localization_only = localization_only
        self.ref_frame: Optional[Frame] = None
        self.ref_frame_id = -1
        self.last_frame: Optional[Frame] = None
        self._pending_last_frame: Optional[Frame] = None  # the truncated init frame
        self.last_assoc: Optional[tr.TrackObs] = None
        self.last_Tcw = se3.identity(device=self.device)
        self.last_kf_slot = -1
        self.last_kf_frame_id = -1
        self.frame_id = -1
        self._reloc_frame_id = -10000
        self.trajectory: List[TrajectoryEntry] = []
        self._odom_history = {}   # trajectory index -> odometry (the pre-init backfill)
        self._kf_alive = {}       # frame id -> last seen pose of the live keyframes
        self._dead_kf_poses = {}  # frame id -> pose when its keyframe was culled
        self.frame_times: List[float] = []
        self.tracer = Tracer()
        # loop closing (place recognition, Sim3 solver, pose graphs) is not
        # ported yet (ROADMAP queue 1 item 5): it stays off, and track raises
        # at a keyframe insertion if it is switched on
        self.enable_loop_closing = False
        self.n_forced_kf_evictions = 0
        # (Tcw, odom) of the last pose before a reset: the next initialization
        # chains its world gauge onto the dead-reckoned continuation of it
        self._reset_anchor = None
        self._velocity = se3.identity(device=self.device)
        # the RANSAC hypotheses' Gumbel noise, drawn on the host (the JAX
        # package's PRNGKey(7) chain); replaceable by any callable of the
        # same signature
        self.draws = init_mod.GumbelDraws(7)
        self.inits: List[dict] = []   # one record per successful initialization
        # the tracking core's counts of the last tracked frame: motion-model
        # matches, inliers, reference-keyframe points with 3 / 2 observations,
        # bird inliers, reference-keyframe bird points, live keyframes
        self.last_scalars: Optional[list] = None
        self._Tcw_host = np.zeros(7, np.float32)

    # ------------------------------------------------------------------ utils
    def _gumbel(self, n: int, n_points: int, n_iters: int = 200):
        return tuple(g.to(self.device) for g in self.draws(n, n_iters, n_points))

    def _odom_T21(self, f1: Frame, f2: Frame):
        """T_c2_c1 from odometry (the initializer's scale and rotation)."""
        return se3.inverse(odo.preintegrate_cam(self.cfg.extrinsics, f1.odom, f2.odom))

    def _read(self, f: Frame, Tcw, scalars=None) -> dict:
        """What the host keeps of a frame, in one device-to-host copy: its pose,
        that pose relative to the reference keyframe, the odometry, the
        timestamp and, with ``scalars``, the tracking core's counts."""
        ref = self.last_kf_slot
        rel = ref >= 0 and self.map is not None
        parts = [Tcw.reshape(7), f.odom.reshape(3), f.timestamp.reshape(1)]
        if rel:
            parts.append(se3.compose(Tcw, se3.inverse(self.map.kf_Tcw[ref])))
        if scalars is not None:
            parts.append(scalars.to(torch.float32))
        h = torch.cat(parts).cpu().numpy()
        out = dict(ref=ref, Tcw=h[:7], odom=h[7:10], ts=float(h[10]),
                   T_rel=h[11:18] if rel else h[:7])
        if scalars is not None:
            out["scalars"] = [int(x) for x in h[h.shape[0] - scalars.shape[0]:]]
        return out

    def _record(self, f: Frame, Tcw, is_kf: bool, host: Optional[dict] = None):
        if host is None or host["ref"] != self.last_kf_slot:
            host = self._read(f, Tcw)
        self._odom_history[len(self.trajectory)] = host["odom"]
        self.trajectory.append(TrajectoryEntry(host["ts"], host["T_rel"], self.last_kf_slot,
                                               is_kf, self.state, self.last_kf_frame_id))
        self._Tcw_host = host["Tcw"]

    def _kf_table(self):
        """(valid (K,), frame ids (K,), poses (K, 7), insertion order (K,),
        timestamps (K,)) of the keyframe slots, in one copy."""
        m = self.map
        cols = torch.stack([m.kf_valid.to(torch.float32), m.kf_frame_id.to(torch.float32),
                            m.kf_seq.to(torch.float32), m.kf_timestamp], dim=1)
        h = torch.cat([cols, m.kf_Tcw], dim=1).cpu().numpy()
        return (h[:, 0] > 0, h[:, 1].astype(np.int64), h[:, 4:11].copy(),
                h[:, 2].astype(np.int64), h[:, 3].copy())

    def _refresh_kf_snapshot(self):
        """Track the live keyframes by frame id and keep the final pose of any
        keyframe that culling retired, so trajectory entries anchored to it
        stay meaningful after its slot is recycled."""
        if self.map is None:
            return
        valid, fids, poses = self._kf_table()[:3]
        new = {int(fids[k]): poses[k] for k in np.nonzero(valid)[0]}
        for fid, pose in self._kf_alive.items():
            if fid not in new:
                self._dead_kf_poses[fid] = pose
        self._kf_alive = new

    def _entry_Tcw(self, e: TrajectoryEntry, fid_to_slot, kf_Tcw) -> np.ndarray:
        """Absolute Tcw of a trajectory entry under the current map, falling
        back to the cull-time pose when its reference keyframe is gone."""
        if e.ref_kf >= 0:
            slot = fid_to_slot.get(e.ref_frame_id)
            if slot is not None and kf_Tcw is not None:
                return _np_compose(e.T_rel, kf_Tcw[slot])
            dead = self._dead_kf_poses.get(e.ref_frame_id)
            if dead is not None:
                return _np_compose(e.T_rel, dead)
        return np.asarray(e.T_rel)

    def _fid_to_slot(self):
        if self.map is None:
            return {}
        valid, fids = self._kf_table()[:2]
        return {int(fids[k]): int(k) for k in np.nonzero(valid)[0]}

    # ------------------------------------------------------------------ API
    def track(self, front_gray, bird_gray, bird_mask, odom, timestamp,
              contour=None) -> np.ndarray:
        """Process one frame; returns its Tcw estimate (7,).

        ``contour``: an optional bird-view contour label image (edge pixels
        < 150); bird keypoints then stay near the contour, as in the
        reference's Frame constructor (``Frame.cc:671-739``)."""
        t0 = time.perf_counter()
        self.frame_id += 1
        # the front budget is doubled while uninitialized (Tracking.cc:127-133);
        # the init pair is cut back to capacity when the map is created
        cap = self.cfg.capacity
        n_front = (max(self.cfg.orb.n_features_init, cap.max_front_kp)
                   if self.state == tr.NOT_INITIALIZED else cap.max_front_kp)
        with self.tracer.span("frame_build"):
            front_gray, bird_gray, bird_mask, odom, contour = self._upload(
                front_gray, bird_gray, bird_mask, odom, contour)
            f = build_frame(front_gray, bird_gray, bird_mask, odom, timestamp, self.cfg, n_front,
                            contour, cap.max_bird_kp, device=self.device)
        if self.state == tr.NOT_INITIALIZED:
            with self.tracer.span("initialize"):
                Tcw = self._initialize(f)
        elif self.state == tr.OK:
            with self.tracer.span("track"):
                Tcw = self._track_ok(f)
        else:
            with self.tracer.span("track_lost"):
                Tcw = self._track_lost(f)
        if self.last_frame is not None:
            # mVelocity = Tcw_cur * Twc_last (Tracking.cc:683-694)
            self._velocity = se3.compose(Tcw, se3.inverse(self.last_Tcw))
        # after a two-view initialization the frame in hand carries the doubled
        # budget; its truncated copy is the next frame's last frame
        self.last_frame = f if self._pending_last_frame is None else self._pending_last_frame
        self._pending_last_frame = None
        self.last_Tcw = Tcw
        self.frame_times.append(time.perf_counter() - t0)
        return self._Tcw_host.copy()

    def _upload(self, *inputs):
        """A frame's host inputs (numpy arrays, ``None`` passes through) as f32
        tensors on a CUDA device, in one non-blocking copy from pinned memory:
        a copy from pageable memory waits for the card, once per array.  The
        caching host allocator reuses the pinned block only once its copy is
        done.  Inputs already tensors, or a CPU device, go as they are."""
        if self.device.type != "cuda" or not all(
                isinstance(x, np.ndarray) or x is None for x in inputs):
            return inputs
        arrays = [None if x is None else np.asarray(x, np.float32) for x in inputs]
        sizes = [0 if a is None else a.size for a in arrays]
        host = torch.empty(sum(sizes), dtype=torch.float32, pin_memory=True)
        flat = host.numpy()
        off = 0
        for a, n in zip(arrays, sizes):
            if a is not None:
                flat[off:off + n] = a.reshape(-1)
            off += n
        dev = host.to(self.device, non_blocking=True)
        out, off = [], 0
        for a, n in zip(arrays, sizes):
            out.append(None if a is None else dev[off:off + n].view(a.shape))
            off += n
        return out

    # ---------------------------------------------------------------- states
    def _restart_pair(self, f: Frame):
        self.ref_frame = f
        self.ref_frame_id = self.frame_id
        return self._identity_record(f)

    def _identity_record(self, f: Frame):
        Tcw = se3.identity(device=self.device)
        self._record(f, Tcw, False)
        return Tcw

    def _initialize(self, f: Frame):
        cfg = self.cfg
        if self.ref_frame is None:
            return self._restart_pair(f)
        f1 = self.ref_frame
        res = tr.match_for_init(f1, f, cfg)
        n = int(res.count)
        T21_odom = self._odom_T21(f1, f)
        bird_ok = cfg.flags.have_bird and cfg.tracking.min_bird_init_matches > 0
        init_out, route = None, None
        if n < cfg.tracking.min_init_matches:
            # too few front matches (Tracking.cc:854-861): the bird-seeded
            # bootstrap before the pair restarts
            if bird_ok:
                init_out, route = tr.bird_seeded_init(f1, f, cfg, res)[0], "bird"
            if init_out is None or not bool(init_out.success):
                return self._restart_pair(f)
        if init_out is None:
            uv2 = tr._matched_uv2(f1, f, res)
            n_pts = res.ok.shape[0]
            init_out = init_mod.initialize(cfg.camera, f1.uv, uv2, res.ok, T21_odom,
                                           self._gumbel(2, n_pts),
                                           loose_couple=cfg.flags.loose_couple)
            ok, used_h = (bool(x) for x in torch.stack([init_out.success,
                                                        init_out.used_h]).tolist())
            route = "H" if used_h else "F"
            if not ok and cfg.flags.loose_couple:
                # planar or degenerate F: the odometry-rotation hypothesis
                init_out, route = init_mod.reinitialize(
                    cfg.camera, f1.uv, uv2, res.ok, T21_odom, self._gumbel(1, n_pts)[0]), "reinit"
                ok = bool(init_out.success)
            if not ok and bird_ok:
                init_out, route = tr.bird_seeded_init(f1, f, cfg, res)[0], "bird"
        if not bool(init_out.success):
            return self._identity_record(f)
        f1m, f2m = f1, f
        if f.uv.shape[0] != cfg.capacity.max_front_kp:
            f1m, f2m, res, init_out = tr.truncate_init_frames(f1m, f2m, res, init_out,
                                                              cfg.capacity.max_front_kp)
            self._pending_last_frame = f2m
        m = tr.create_initial_map(f1m, f2m, init_out, cfg, res, (self.ref_frame_id, self.frame_id),
                                  device=self.device)
        n_points = m.n_mp
        # the initial bundle adjustment (GlobalBundleAdjustemntWithOdom,
        # Tracking.cc:994), then the fresh points' normals, descriptors and
        # scale ranges, which the frustum and octave gates need
        m = tr.update_point_stats(tr.local_ba(m, cfg, 1), cfg)
        if self._reset_anchor is not None:
            # chain this submap onto the dead-reckoned continuation of the pose
            # before the reset
            aT, aodom = self._reset_anchor
            self._reset_anchor = None
            Tcw1 = odo.motion_prior_Tcw(cfg.extrinsics, torch.as_tensor(aT, device=self.device),
                                        torch.as_tensor(aodom, device=self.device), f1.odom)
            m = tr.apply_world_gauge(m, Tcw1)
        self.map = m
        self.state = tr.OK
        self._reloc_frame_id = self.frame_id
        self.last_kf_slot = 1
        self.last_kf_frame_id = self.frame_id
        self.last_assoc = tr.TrackObs(m.kf_mp[1], m.kf_bird_mp[1])
        self._backfill(m, f1.odom)
        counts = torch.stack([n_points, m.n_mp, m.n_bp]).tolist()
        self.inits.append(dict(frame=self.frame_id, ref_frame=self.ref_frame_id, route=route,
                               matches=n, T21=init_out.T21.cpu().numpy(), triangulated=counts[0],
                               n_mp=counts[1], n_bp=counts[2]))
        Tcw = m.kf_Tcw[1]
        self._record(f, Tcw, True)
        return Tcw

    def _backfill(self, m: ms.MapState, ref_odom):
        """The frames recorded at the identity before this initialization, put
        at their odometry dead-reckoning relative to the first keyframe."""
        idx = [i for i, e in enumerate(self.trajectory)
               if e.ref_kf == -1 and i in self._odom_history]
        if not idx:
            return
        odoms = torch.as_tensor(np.stack([self._odom_history[i] for i in idx]),
                                device=self.device)
        Tcw0 = m.kf_Tcw[0]
        Tcw_i = odo.motion_prior_Tcw(self.cfg.extrinsics, Tcw0, ref_odom, odoms)
        T_rel = se3.compose(Tcw_i, se3.inverse(Tcw0)).cpu().numpy()
        for r, i in enumerate(idx):
            e = self.trajectory[i]
            e.T_rel, e.ref_kf, e.ref_frame_id = T_rel[r], 0, self.ref_frame_id

    def _motion_prior(self, f: Frame):
        """The odometry delta under ``loose_couple`` (``Tracking.cc:1316-1320``),
        else the constant-velocity model (``Tracking.cc:1330``)."""
        if self.cfg.flags.loose_couple:
            return odo.motion_prior_Tcw(self.cfg.extrinsics, self.last_Tcw, self.last_frame.odom,
                                        f.odom)
        return se3.compose(self._velocity, self.last_Tcw)

    def _track_ok(self, f: Frame):
        cfg = self.cfg
        m = self.map
        Tcw_pred = self._motion_prior(f)
        cand_last = torch.cat([self.last_assoc.mp_idx, m.kf_mp[self.last_kf_slot]])
        core = tr.track_frame_core(m, f, cfg, Tcw_pred, cand_last, max(self.last_kf_slot, 0),
                                   last_f=tr.bird_only_view(self.last_frame),
                                   last_bp_idx=self.last_assoc.bp_idx, last_Tcw=self.last_Tcw,
                                   bird_maint_enabled=True, device=self.device)
        self.map = m = core.map
        Tcw = core.Tcw
        assoc = tr.TrackObs(core.mp_idx, core.bp_idx)
        host = self._read(f, Tcw, core.scalars)
        self.last_scalars = host["scalars"]
        n_mm, n_in, nref3, nref2, n_bird_cur, n_ref_bird, n_kfs = host["scalars"]
        if n_mm < 10:
            raise NotImplementedError(
                f"frame {self.frame_id}: {n_mm} motion-model matches; the TrackReferenceKeyFrame "
                "fallback needs relocalize_against, which is not ported yet (ROADMAP queue 1 "
                "item 5)")
        # TrackLocalMap's success gate (>= 30 inliers, Tracking.cc:1429-1441),
        # relaxed to 10 within 2 fps frames of an initialization
        recent_reloc = self.frame_id - self._reloc_frame_id < 2 * cfg.camera.fps
        min_ok = 10 if recent_reloc else cfg.tracking.min_inliers_ok
        if n_in < min_ok:
            if int(m.kf_counter) <= 5 and not self.localization_only:
                # lost with a barely-born map: full reset (Tracking.cc:731-740)
                self.reset()
                self._record(f, Tcw, False)
                return Tcw
            self.state = tr.LOST
            self._record(f, Tcw, False, host)
            self.last_assoc = assoc
            return Tcw

        self.last_assoc = assoc
        # NeedNewKeyFrame (Tracking.cc:1444-1540); mapping is always idle here
        need, _ = tr.need_new_keyframe(
            cfg, localization_only=self.localization_only, n_kfs=n_kfs, frame_id=self.frame_id,
            last_kf_frame_id=self.last_kf_frame_id, last_reloc_frame_id=self._reloc_frame_id,
            n_inliers=n_in, n_ref_matches=nref3 if n_kfs > 2 else nref2, mapping_idle=True,
            n_bird_matched=n_bird_cur, n_ref_bird=n_ref_bird)
        is_kf = False
        if need:
            slot, slot_ok = self._free_slot(m)
            if not slot_ok:
                # every slot live and culling found nothing: evict the
                # least-connected eligible keyframe so insertion never stops
                self.map = m = tr.force_evict_keyframe(m, cfg)
                self.n_forced_kf_evictions += 1
                self._refresh_kf_snapshot()
                slot, slot_ok = self._free_slot(m)
            need = slot_ok
        if need:
            if self.enable_loop_closing:
                raise NotImplementedError(
                    "loop closing is not ported yet (ROADMAP queue 1 item 5); set "
                    "enable_loop_closing = False")
            m = tr.insert_keyframe(m, f, assoc, Tcw, cfg, self.frame_id, slot=slot,
                                   device=self.device)
            m = tr.local_mapping_step(m, slot, cfg, cfg.tracking.mapping_neighbors,
                                      device=self.device)
            self.map = m
            Tcw = m.kf_Tcw[slot]
            self._refresh_kf_snapshot()  # mapping may have culled a keyframe
            self.last_kf_slot = slot
            self.last_kf_frame_id = self.frame_id
            self.last_assoc = tr.TrackObs(m.kf_mp[slot], m.kf_bird_mp[slot])
            is_kf = True
        self._record(f, Tcw, is_kf, None if is_kf else host)
        return Tcw

    @staticmethod
    def _free_slot(m: ms.MapState):
        slot, ok, _ = tr.free_kf_slot(m)
        slot, ok = torch.stack([slot, ok.to(torch.int32)]).tolist()
        return slot, bool(ok)

    def _track_lost(self, f: Frame):
        raise NotImplementedError(
            "the LOST state's recovery (bird-only tracking, relocalization, re-initialization "
            "into a new submap) needs relocalize_against and the PnP solver, which are not "
            "ported yet (ROADMAP queue 1 items 5 and 6)")

    def finish(self):
        """The synchronous mode has no mapping in flight: nothing to drain."""

    def reset(self):
        """``System::Reset``: drop the map and return to NOT_INITIALIZED.  The
        recorded entries are frozen to absolute poses first (their reference
        keyframes go); ``ref_kf = -2`` exempts them from the next
        initialization's backfill."""
        self.finish()
        if self.last_frame is not None:
            self._reset_anchor = (self.last_Tcw.cpu().numpy(),
                                  self.last_frame.odom.cpu().numpy())
        kf_Tcw = None if self.map is None else self._kf_table()[2]
        fid_to_slot = self._fid_to_slot()
        for e in self.trajectory:
            if e.ref_kf >= 0:
                e.T_rel = self._entry_Tcw(e, fid_to_slot, kf_Tcw)
            if e.ref_kf != -1:
                e.ref_kf = -2
        self._kf_alive = {}
        self._dead_kf_poses = {}
        self.map = None
        self.state = tr.NOT_INITIALIZED
        self.ref_frame = None
        self.ref_frame_id = -1
        self._pending_last_frame = None
        self.last_assoc = None
        self.last_kf_slot = -1
        self.last_kf_frame_id = -1

    def activate_localization_mode(self):
        """``System::ActivateLocalizationMode``: no keyframe insertion or
        mapping; tracking goes on against the frozen map."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    # ------------------------------------------------------------- trajectory
    def _kf_order(self):
        valid, fids, poses, seq, ts = self._kf_table()
        order = sorted((int(k) for k in np.nonzero(valid)[0]), key=lambda k: int(seq[k]))
        return order, fids, poses, ts

    def keyframe_trajectory_tum(self) -> str:
        """``SaveKeyFrameTrajectoryOdomTUM`` (``System.cc:543-585``): TUM lines
        of the base-frame world poses Twb of the live keyframes."""
        if self.map is None:
            return ""
        order, _, poses, ts = self._kf_order()
        Twb = ipm.Twb_from_Twc(self.cfg.extrinsics,
                               se3.inverse(torch.as_tensor(poses[order]))).numpy()
        lines = []
        for k, T in zip(order, Twb):
            q, t = T[:4], T[4:]  # wxyz
            lines.append(f"{float(ts[k]):.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                         f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
        return "\n".join(lines) + "\n"

    def timing_stats(self) -> dict:
        """Median and mean per-frame time (``mono_encoder.cc:202-210``) and the
        tracer's spans."""
        if not self.frame_times:
            return {"median_s": 0.0, "mean_s": 0.0, "fps": 0.0, "stages": self.tracer.report()}
        t = np.sort(np.asarray(self.frame_times))
        return {"median_s": float(t[len(t) // 2]), "mean_s": float(t.mean()),
                "fps": float(1.0 / max(t.mean(), 1e-9)), "stages": self.tracer.report()}

    def keyframe_indices(self) -> np.ndarray:
        """Source frame id of each live keyframe in insertion order
        (``System::SaveKeyFrameIdx``, ``System.cc:587-613``)."""
        if self.map is None:
            return np.zeros((0,), np.int32)
        order, fids = self._kf_order()[:2]
        return np.asarray([int(fids[k]) for k in order], np.int32)

    def frame_trajectory_Twb(self) -> np.ndarray:
        """(N, 7) per-frame base poses for ATE, composed against the current
        keyframe poses so that BA corrections reach them."""
        if not self.trajectory:
            return np.zeros((0, 7))
        kf_Tcw = None if self.map is None else self._kf_table()[2]
        fid_to_slot = self._fid_to_slot()
        Tcw = np.stack([self._entry_Tcw(e, fid_to_slot, kf_Tcw) for e in self.trajectory])
        return ipm.Twb_from_Twc(self.cfg.extrinsics,
                                se3.inverse(torch.as_tensor(Tcw, dtype=torch.float32))).numpy()
