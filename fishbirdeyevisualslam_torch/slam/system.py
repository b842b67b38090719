"""System facade — the port of ``fishbirdeyevisualslam_tpu/slam/system.py``
(the reference's ``System`` and the ``Tracking`` thread body,
``src/System.cc``, ``src/Tracking.cc:479-770``): the map state, the
NOT_INITIALIZED / OK / LOST state machine, two-view initialization,
tracking with its reference-keyframe fallback, the keyframe policy with
insertion, local mapping and loop closing, the LOST state's recovery
(bird-only tracking, BoW + PnP relocalization, re-initialization into a new
submap), and the per-frame trajectory.

``SlamSystem.track`` is the entry point, one call per frame.  Everything runs
on ``device`` (the current CUDA card unless the caller names another).  A
frame's images and odometry reach the card in one non-blocking copy, and
the host reads of a tracked frame that inserts no keyframe are those of
``track_frame_core`` and one copy of the frame's counts, pose and record.

Mapping runs after each keyframe insertion, synchronously by default.  With
``async_mapping=True`` it runs as the reference's LocalMapping thread
(``System.cc:96-111``): a stage of the native pipeline
(``runtime/native.py``) works on a snapshot of the map, on a CUDA stream of
its own, while tracking goes on with the map as inserted; the result is
merged at the next frame boundary, with the bird points tracking created
meanwhile replayed into it and the keyframes it inserted during a loop
correction replayed through that correction (``_consume_pending``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import resolve_device, upload
from fishbirdeyevisualslam_torch.geometry import ipm, se3
from fishbirdeyevisualslam_torch.geometry import odometry as odo
from fishbirdeyevisualslam_torch.io.tracing import Tracer
from fishbirdeyevisualslam_torch.ops import vocab
from fishbirdeyevisualslam_torch.slam import loop_closing as lc
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


class MappingJob(NamedTuple):
    """A keyframe handed to the mapping stage: the map snapshot with the
    keyframe inserted in ``slot``, its frame, the pose of the frame before
    it (its velocity is taken again from the refined pose at the merge),
    its trajectory entry, and on a card the event that tracking's stream
    recorded after the snapshot's last write."""

    map: ms.MapState
    slot: int
    frame_id: int
    prev_Tcw: torch.Tensor
    entry: int
    ready: Optional[torch.cuda.Event]


class MappingResult(NamedTuple):
    map: ms.MapState
    closed: bool     # a loop was closed
    aborted: bool    # InterruptBA: local BA, keyframe culling and loop closing skipped
    job: MappingJob


class SlamSystem:
    """``System::TrackMonocularWithOdom``: call ``track`` once per frame."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), localization_only: bool = False,
                 async_mapping: bool = False, device=None):
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
        self.ref_kf_tracked = 0   # tracked points of the last keyframe when inserted
        self.frame_id = -1
        self.n_lost_frames = 0
        self._reloc_frame_id = -10000
        self.trajectory: List[TrajectoryEntry] = []
        self._odom_history = {}   # trajectory index -> odometry (the pre-init backfill)
        self._kf_alive = {}       # frame id -> last seen pose of the live keyframes
        self._dead_kf_poses = {}  # frame id -> pose when its keyframe was culled
        self.frame_times: List[float] = []
        self.tracer = Tracer()
        self.loop_closer = lc.LoopCloser(cfg)
        self.loop_closer.tracer = self.tracer
        self.enable_loop_closing = True
        self.n_loops_closed = 0
        self.n_forced_kf_evictions = 0
        # (Tcw, odom) of the last pose before a reset: the next initialization
        # chains its world gauge onto the dead-reckoned continuation of it
        self._reset_anchor = None
        self._velocity = se3.identity(device=self.device)
        # the RANSAC hypotheses' Gumbel noise of initialization,
        # re-initialization and relocalization, drawn on the host (the JAX
        # package's PRNGKey(7) chain); replaceable by any callable of the
        # same signature
        self.draws = init_mod.GumbelDraws(7)
        # how the last frame was tracked: "uninitialized", "init", "core", "fallback",
        # "bird-only" (LOST, with or without a bird keyframe), "relocalized",
        # "reinitialized" or "reset"; and its inliers where the route has a
        # pose optimisation (the bird inliers of "bird-only")
        self.last_route: Optional[str] = None
        self.last_inliers: Optional[int] = None
        self.inits: List[dict] = []   # one record per successful initialization
        # the tracking core's counts of the last tracked frame: motion-model
        # matches, inliers, reference-keyframe points with 3 / 2 observations,
        # bird inliers, reference-keyframe bird points, live keyframes
        self.last_scalars: Optional[list] = None
        self._Tcw_host = np.zeros(7, np.float32)
        # --- asynchronous mapping (the reference's LocalMapping thread,
        # System.cc:97-98): a job maps a snapshot while tracking continues on
        # the map as inserted; the result is merged at the next frame boundary
        self.async_mapping = async_mapping
        self._pending_result: Optional[MappingResult] = None
        self._mapping_busy = False
        self._mapping_error: Optional[BaseException] = None
        self._kf_journal = []            # keyframes inserted during a loop correction
        self._job_bp_valid = None        # bp_valid of the job's snapshot
        self._job_bp_gen = None          # bp_gen of the snapshot (slot identity)
        self._journal_created_bp = None  # generations of the bird slots journaled inserts made
        self.n_bird_replay_dropped = 0   # frame-born birds lost for want of a slot
        self.n_journal_kfs_dropped = 0   # journaled keyframes lost for want of a slot
        self.n_jobs_submitted = self.n_jobs_merged = self.n_jobs_aborted = 0
        self.n_journal_kfs = 0           # keyframes journaled
        self.n_birds_replayed = 0        # frame-born birds replayed into results
        self.n_frames_in_flight = 0      # frames tracked while a job was in flight
        self._pipeline = None
        self._mapping_stream = None
        if async_mapping:
            from fishbirdeyevisualslam_torch.runtime.native import AsyncPipeline
            self._mapping_jobs = {}
            if self.device.type == "cuda":
                self._mapping_stream = torch.cuda.Stream(self.device)
            self._pipeline = AsyncPipeline([self._mapping_stage], capacity=2)

    # ------------------------------------------------------------------ utils
    def _gumbel(self, n: int, n_points: int, n_iters: int = 200):
        return tuple(upload(g, self.device) for g in self.draws(n, n_iters, n_points))

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

    # ------------------------------------------------------- async mapping
    def _mapping_context(self, job: MappingJob):
        """The worker's device context: on a card, the mapping stream, after
        the event tracking's stream recorded behind the snapshot."""
        if self._mapping_stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._mapping_stream))
        self._mapping_stream.wait_event(job.ready)
        return stack

    def _sync_mapping(self):
        """Wait for the mapping stream's work (JAX's ``block_until_ready``);
        tracking's stream goes on."""
        if self._mapping_stream is not None:
            self._mapping_stream.synchronize()

    def _mapping_stage(self, stage: int, item: int):
        """Runs in the pipeline's worker thread: ``local_mapping_pre``, then,
        unless tracking asked for an InterruptBA meanwhile (the reference's
        ``mbAbortBA`` check before BA, ``LocalMapping.cc:85-97``), local BA
        with keyframe culling and loop closing, on the job's snapshot.  An
        exception is kept for the merge to raise."""
        try:
            job = self._mapping_jobs.pop(item)
            cfg = self.cfg
            with self._mapping_context(job):
                m = tr.local_mapping_pre(job.map, job.slot, cfg, cfg.tracking.mapping_neighbors,
                                         device=self.device)
                self._sync_mapping()
                aborted = self._pipeline.abort_requested(0)
                closed = False
                if not aborted:
                    m = tr.local_mapping_ba(m, job.slot, cfg, device=self.device)
                    if self.enable_loop_closing:
                        m, closed = self.loop_closer.process_keyframe(m, job.slot)
                self._sync_mapping()   # the snapshot stays referenced until here
            self._pending_result = MappingResult(m, bool(closed), aborted, job)
        except BaseException as e:   # noqa: BLE001 (ctypes would print and drop it)
            self._mapping_error = e
        finally:
            self._mapping_busy = False

    def _job_in_flight(self) -> bool:
        """A job submitted and not merged yet: running, or finished with its
        result (or its exception) waiting for the next frame boundary.  The
        worker sets the result before it clears ``_mapping_busy``, so the
        flag is read first."""
        return (self._mapping_busy or self._pending_result is not None
                or self._mapping_error is not None)

    def _submit_job(self, m: ms.MapState, slot: int):
        """Hand the map with its new keyframe in ``slot`` to the mapping stage.
        On a card, the snapshot's tensors are marked as used by the mapping
        stream, so the caching allocator does not hand their blocks to
        tracking's stream while the worker still reads them, and an event
        orders the worker behind the snapshot's writes."""
        ready = None
        if self._mapping_stream is not None:
            for t in m:
                t.record_stream(self._mapping_stream)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._mapping_busy = True
        self._job_bp_valid, self._job_bp_gen = m.bp_valid, m.bp_gen
        self._mapping_jobs[self.frame_id] = MappingJob(m, slot, self.frame_id, self.last_Tcw,
                                                       len(self.trajectory), ready)
        self.n_jobs_submitted += 1
        self._pipeline.submit(self.frame_id)

    def _take_result(self) -> Optional[MappingResult]:
        """The finished job's result, its tensors marked as used by tracking's
        stream (they were allocated on the mapping stream); raises the
        worker's exception."""
        if self._mapping_error is not None:
            e, self._mapping_error = self._mapping_error, None
            raise RuntimeError("the asynchronous mapping job failed") from e
        res, self._pending_result = self._pending_result, None
        if res is not None and self._mapping_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._mapping_stream)
            for t in res.map:
                t.record_stream(cur)
        return res

    def _consume_pending(self):
        """Merge a finished mapping job into the live map and replay what
        tracking did meanwhile (the reference's propagation of concurrently
        created keyframes after a background correction,
        ``LoopClosing.cc:674-841``): the frame-born bird points tracking
        created since the snapshot go into the result (``replay_bird_points``;
        a slot is born if it was free at the snapshot or its generation
        changed since), and each journaled keyframe re-enters at its relative
        pose to its reference keyframe composed onto that reference's merged
        pose, or onto its cull-time pose where the reference died.  Where no
        frame was tracked since the job's keyframe (a flushed pipeline),
        tracking continues from the refined keyframe, its pose, velocity,
        associations and trajectory entry taken as the synchronous mode takes
        them (``Tracking::UpdateLastFrame``)."""
        res = self._take_result()
        if res is None:
            return
        m, job = res.map, res.job
        self.n_jobs_merged += 1
        self.n_jobs_aborted += int(res.aborted)
        remap = None
        live = self.map
        if live is not None and self.cfg.flags.have_bird and self._job_bp_valid is not None:
            born = live.bp_valid & (~self._job_bp_valid | (live.bp_gen != self._job_bp_gen))
            if self._journal_created_bp is not None:
                born = born & ~(self._journal_created_bp == live.bp_gen)
            m, remap, n_drop = tr.replay_bird_points(m, live, born)
            n_born, n_drop = torch.stack([torch.sum(born.to(torch.int32)), n_drop]).tolist()
            self.n_birds_replayed += n_born - n_drop
            self.n_bird_replay_dropped += n_drop
        self._job_bp_valid = self._job_bp_gen = self._journal_created_bp = None
        self.map = m
        self.n_loops_closed += int(res.closed)
        if self._kf_journal:
            self._replay_journal(remap)
        self._refresh_kf_snapshot()
        if self.last_assoc is not None:
            # tracking's bird ids refer to the map before the merge: through the
            # remap (the identity for surviving points, the new slot of a
            # frame-born one, -1 for lost ones)
            bp = self.last_assoc.bp_idx
            if remap is not None:
                bp = torch.where(bp >= 0, remap[bp.clamp(0, remap.shape[0] - 1).long()], -1)
            else:
                bp = torch.full_like(bp, -1)
            self.last_assoc = tr.TrackObs(self.last_assoc.mp_idx, bp)
        if len(self.trajectory) == job.entry + 1 and self.last_kf_frame_id == job.frame_id:
            Tcw = self.map.kf_Tcw[job.slot]
            self.last_Tcw = Tcw
            self._velocity = se3.compose(Tcw, se3.inverse(job.prev_Tcw))
            self.last_assoc = tr.TrackObs(self.map.kf_mp[job.slot], self.map.kf_bird_mp[job.slot])
            self.trajectory[job.entry].T_rel = se3.compose(
                Tcw, se3.inverse(self.map.kf_Tcw[job.slot])).cpu().numpy()

    def _replay_journal(self, remap):
        """Insert the journaled keyframes into the merged map."""
        cfg = self.cfg
        PB = self.map.bp_pos.shape[0]
        last = None
        pose = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device)
        for e in self._kf_journal:
            ref_slot = self._fid_to_slot().get(e["ref_fid"])
            T_rel = se3.compose(pose(e["Tcw"]), se3.inverse(pose(e["T_ref_live"])))
            if ref_slot is not None:
                Tcw = se3.compose(T_rel, self.map.kf_Tcw[ref_slot])
            elif e["ref_fid"] in self._dead_kf_poses:
                Tcw = se3.compose(T_rel, pose(self._dead_kf_poses[e["ref_fid"]]))
            else:
                Tcw = pose(e["Tcw"])
            slot, n_free, _ = self._slot_counts(self.map)
            if not n_free:
                # starved of slots at the merge: the pressure valve first
                self.map = tr.force_evict_keyframe(self.map, cfg)
                self.n_forced_kf_evictions += 1
                self._refresh_kf_snapshot()
                slot, n_free, _ = self._slot_counts(self.map)
            if not n_free:
                self.n_journal_kfs_dropped += 1
                continue
            assoc = e["assoc"]
            if remap is not None:
                # bird ids recorded against the live map: through the replay's remap
                bp = assoc.bp_idx
                assoc = tr.TrackObs(assoc.mp_idx, torch.where(
                    bp >= 0, remap[bp.clamp(0, PB - 1).long()], -1))
            self.map = tr.insert_keyframe(self.map, e["f"], assoc, Tcw, cfg, e["frame_id"],
                                          slot=slot, device=self.device)
            last = (slot, e["frame_id"])
        if last is not None:
            self.last_kf_slot, self.last_kf_frame_id = last
            self.last_assoc = tr.TrackObs(self.map.kf_mp[last[0]], self.map.kf_bird_mp[last[0]])
        self._kf_journal = []

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
        # merge a finished mapping job at the frame boundary
        self._consume_pending()
        self.n_frames_in_flight += int(self._job_in_flight())
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
        self.last_route, self.last_inliers = "uninitialized", None
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
        counts = torch.stack([n_points, m.n_mp, m.n_bp,
                              torch.sum((m.kf_mp[1] >= 0).to(torch.int32))]).tolist()
        self.ref_kf_tracked = counts[3]
        self.inits.append(dict(frame=self.frame_id, ref_frame=self.ref_frame_id, route=route,
                               matches=n, T21=init_out.T21.cpu().numpy(), triangulated=counts[0],
                               n_mp=counts[1], n_bp=counts[2]))
        Tcw = m.kf_Tcw[1]
        self.last_route, self.last_inliers = "init", None
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

    def _fused(self) -> bool:
        return self.cfg.tracking.use_fused_matcher and self.device.type == "cuda"

    def _track_ok(self, f: Frame):
        cfg = self.cfg
        m = self.map
        Tcw_pred = self._motion_prior(f)
        cand_last = torch.cat([self.last_assoc.mp_idx, m.kf_mp[self.last_kf_slot]])
        core = tr.track_frame_core(m, f, cfg, Tcw_pred, cand_last, max(self.last_kf_slot, 0),
                                   last_f=tr.bird_only_view(self.last_frame),
                                   last_bp_idx=self.last_assoc.bp_idx, last_Tcw=self.last_Tcw,
                                   bird_maint_enabled=True, device=self.device)
        Tcw = core.Tcw
        assoc = tr.TrackObs(core.mp_idx, core.bp_idx)
        host = self._read(f, Tcw, core.scalars)
        self.last_scalars = host["scalars"]
        n_mm, n_in, nref3, nref2, n_bird_cur, n_ref_bird, n_kfs = host["scalars"]
        self.last_route = "core"
        if n_mm < 10:
            # TrackReferenceKeyFrame (Tracking.cc:1180-1244): BoW-gated match
            # against the reference keyframe, then the local-map step again
            # from its pose, on the map as it was before the core's updates
            fb = self._fallback(m, f, Tcw_pred, n_mm)
            if fb is not None:
                n_in, Tcw, assoc = fb
                host = None
                self.last_route = "fallback"
        self.last_inliers = n_in
        self.map = m = core.map
        # TrackLocalMap's success gate (>= 30 inliers, Tracking.cc:1429-1441),
        # relaxed to 10 within 2 fps frames of an initialization or relocalization
        recent_reloc = self.frame_id - self._reloc_frame_id < 2 * cfg.camera.fps
        min_ok = 10 if recent_reloc else cfg.tracking.min_inliers_ok
        if n_in < min_ok:
            if self._pipeline is not None and self._job_in_flight():
                # starved while a job is in flight, on the map before its BA:
                # drain the pipeline, merge, and track the frame again before
                # declaring it lost (the reference's Tracking holds
                # mMutexMapUpdate for the whole frame, Tracking.cc:489)
                self._pipeline.flush()
                self._consume_pending()
                return self._track_ok(f)
            if int(m.kf_counter) <= 5 and not self.localization_only:
                # lost with a barely-born map: full reset (Tracking.cc:731-740)
                self.reset()
                self.last_route = "reset"
                self._record(f, Tcw, False)
                return Tcw
            self.state = tr.LOST
            self.n_lost_frames = 0
            self._record(f, Tcw, False, host)
            self.last_assoc = assoc
            return Tcw

        self.last_assoc = assoc
        # NeedNewKeyFrame (Tracking.cc:1444-1540): a keyframe needed while a
        # job is in flight asks for an InterruptBA instead (mono semantics).
        # Read once: a job that finishes later in this frame stays in flight
        # until the next frame boundary merges it, so no keyframe goes into
        # the live map that the merge would replace
        mapping_idle = not self._job_in_flight()
        need, interrupt = tr.need_new_keyframe(
            cfg, localization_only=self.localization_only, n_kfs=n_kfs, frame_id=self.frame_id,
            last_kf_frame_id=self.last_kf_frame_id, last_reloc_frame_id=self._reloc_frame_id,
            n_inliers=n_in, n_ref_matches=nref3 if n_kfs > 2 else nref2,
            mapping_idle=mapping_idle, n_bird_matched=n_bird_cur, n_ref_bird=n_ref_bird)
        if interrupt and self._pipeline is not None:
            if self.loop_closer.correcting:
                # a loop correction cannot be interrupted: insert into the live
                # map and journal the keyframe for the merge
                # (RunGlobalBundleAdjustment, LoopClosing.cc:674-841)
                if self._journal_keyframe(m, f, assoc, Tcw, n_in):
                    self._record(f, Tcw, True)
                    return Tcw
            else:
                self._pipeline.signal_abort(0)
        is_kf = False
        if need and mapping_idle:
            slot, n_free, _ = self._slot_counts(m)
            if not n_free:
                # every slot live and culling found nothing: evict the
                # least-connected eligible keyframe so insertion never stops
                self.map = m = tr.force_evict_keyframe(m, cfg)
                self.n_forced_kf_evictions += 1
                self._refresh_kf_snapshot()
                slot, n_free, _ = self._slot_counts(m)
            need = n_free > 0
        if need and mapping_idle:
            m = tr.insert_keyframe(m, f, assoc, Tcw, cfg, self.frame_id, slot=slot,
                                   device=self.device)
            if self.async_mapping:
                # tracking continues on the inserted, unrefined map
                self.map = m
                self._submit_job(m, slot)
            else:
                m = tr.local_mapping_step(m, slot, cfg, cfg.tracking.mapping_neighbors,
                                          device=self.device)
                if self.enable_loop_closing:
                    m, closed = self.loop_closer.process_keyframe(m, slot)
                    self.n_loops_closed += int(closed)
                self.map = m
                Tcw = m.kf_Tcw[slot]
                self._refresh_kf_snapshot()  # mapping may have culled a keyframe
            self.last_kf_slot = slot
            self.last_kf_frame_id = self.frame_id
            self.ref_kf_tracked = n_in
            self.last_assoc = tr.TrackObs(self.map.kf_mp[slot], self.map.kf_bird_mp[slot])
            is_kf = True
        self._record(f, Tcw, is_kf, None if is_kf else host)
        return Tcw

    def _journal_keyframe(self, m: ms.MapState, f: Frame, assoc, Tcw, n_in: int) -> bool:
        """Insert the frame as a keyframe into the live map during a loop
        correction and journal it; the bird slots it creates are recorded by
        generation, so that the merge's replay leaves them to the journal
        (a slot later freed and recycled is born again).  False where no slot
        is free."""
        slot, n_free, _ = self._slot_counts(m)
        if not (n_free and self.last_kf_slot >= 0):
            return False
        T_ref_live = m.kf_Tcw[self.last_kf_slot]
        m2 = tr.insert_keyframe(m, f, assoc, Tcw, self.cfg, self.frame_id, slot=slot,
                                device=self.device)
        created = torch.where(m2.bp_valid & ~m.bp_valid, m2.bp_gen, -1)
        self._journal_created_bp = created if self._journal_created_bp is None \
            else torch.maximum(self._journal_created_bp, created)
        self.map = m2
        self._kf_journal.append(dict(f=f, assoc=assoc, Tcw=Tcw, frame_id=self.frame_id,
                                     ref_fid=self.last_kf_frame_id, T_ref_live=T_ref_live))
        self.n_journal_kfs += 1
        self.last_kf_slot = slot
        self.last_kf_frame_id = self.frame_id
        self.ref_kf_tracked = n_in
        self.last_assoc = tr.TrackObs(m2.kf_mp[slot], m2.kf_bird_mp[slot])
        return True

    def _ransac_noise(self, n_points: int):
        """One RANSAC's (128, n_points) Gumbel noise from ``draws``, on the device."""
        return self._gumbel(1, n_points, lc.RANSAC_ITERS)[0]

    def _fallback(self, m: ms.MapState, f: Frame, Tcw_pred, n_mm: int):
        """The reference-keyframe fallback: relocalize against the last
        keyframe; where that beats the motion model, the first pose
        optimisation from its pose, the local-map and bird matches, the second
        pose optimisation.  Returns (inliers, Tcw, associations) or None."""
        cfg = self.cfg
        words = vocab.word_ids(f.desc_pm1)
        Tcw_r, mp_idx_r, n_r, ok_r = lc.relocalize_against(
            m, f.desc_pm1, words, cfg, f.uv, f.kp_valid, self.last_kf_slot,
            self._ransac_noise(f.uv.shape[0]))
        n_r, ok_r = torch.stack([n_r.to(torch.int32), ok_r.to(torch.int32)]).tolist()
        if not (n_r > n_mm and ok_r):
            return None
        fused = self._fused()
        no_bird = torch.full_like(f.bird_octave, -1)
        out1 = tr.pose_opt_step(m, f, tr.TrackObs(mp_idx_r, no_bird), cfg, Tcw_r, Tcw_pred)
        pt_local, _ = tr.local_map_mask(m, mp_idx_r, cfg)
        res2, _ = tr.match_map_points(m, f, cfg, out1.Tcw, pt_local, 12.0,
                                      float(cfg.matcher.th_high), True, fused)
        mp_idx = torch.where(mp_idx_r >= 0, mp_idx_r, res2.idx)
        bwin = tr.bird_local_mask(m, cfg, out1.Tcw)
        bres2 = tr.match_bird_points(m, f, cfg, out1.Tcw, bwin,
                                     tr.bird_match_precompact(m, cfg, out1.Tcw, bwin, fused), fused)
        out2 = tr.pose_opt_step(m, f, tr.TrackObs(mp_idx, bres2.idx), cfg, out1.Tcw, Tcw_pred)
        assoc = tr.TrackObs(torch.where(out2.front_inlier, mp_idx, -1),
                            torch.where(out2.bird_inlier, bres2.idx, -1))
        return int(out2.n_inliers), out2.Tcw, assoc

    @staticmethod
    def _slot_counts(m: ms.MapState):
        """(first free slot, free slots, live keyframes), one host read."""
        slot, _, n_free = tr.free_kf_slot(m)
        return torch.stack([slot, n_free, torch.sum(m.kf_valid.to(torch.int32))]).tolist()

    def _track_lost(self, f: Frame):
        """Loss recovery (Tracking.cc:2395-2481): bird-only tracking, a bird
        keyframe where the bird map needs one, relocalization, then the
        re-initialization of a new submap against the last frame."""
        cfg = self.cfg
        if self._pipeline is not None:
            # the LOST path appends keyframes, which a job merged later would
            # overwrite: drain the pipeline and merge now (the reference's
            # RequestStop / isStopped handshake, LocalMapping.cc:579-654)
            if self._mapping_busy:
                self._pipeline.flush()
            self._consume_pending()
        m = self.map
        F = f.uv.shape[0]
        Tcw_pred = self._motion_prior(f)
        self.n_lost_frames += 1
        self.last_route = "bird-only"
        no_front = torch.full_like(f.octave, -1)
        # TrackUsingBird (Tracking.cc:2014-2061): bird-only pose refinement
        # against the bird local map; the state stays LOST
        Tcw = Tcw_pred
        n_bird_avail = n_bird_matched = 0
        if cfg.flags.have_bird:
            fused = self._fused()
            bwin = tr.bird_local_mask(m, cfg, Tcw_pred)
            bres_idx = tr.match_bird_points(
                m, f, cfg, Tcw_pred, bwin, tr.bird_match_precompact(m, cfg, Tcw_pred, bwin, fused),
                fused).idx
            n_bird_avail, n_bres = torch.stack(
                [torch.sum(bwin.to(torch.int32)), torch.sum((bres_idx >= 0).to(torch.int32))]
            ).tolist()
            if n_bres >= 10:
                outb = tr.pose_opt_step(m, f, tr.TrackObs(no_front, bres_idx), cfg, Tcw_pred)
                n_bird_matched = int(outb.bird_inlier.sum())
                if n_bird_matched >= 10:
                    Tcw = outb.Tcw
        else:
            bres_idx = torch.full_like(f.bird_octave, -1)
        self.last_inliers = n_bird_matched
        slot, n_free, n_valid = self._slot_counts(m)
        # slot-starved recovery: a map wedged at capacity blocks re-init for
        # good; evict the least-connected keyframes until there is room
        if (not self.localization_only and cfg.tracking.lost_eviction_valve
                and n_free <= 2 and n_valid > 10):
            for _ in range(4):
                m = tr.force_evict_keyframe(m, cfg)
                self.n_forced_kf_evictions += 1
            self.map = m
            self._refresh_kf_snapshot()
            slot, n_free, n_valid = self._slot_counts(m)
        # BirdNeedKF (Tracking.cc:2063-2083): extend the bird map with this
        # frame where its matches cover under 70% of the local bird map, in
        # maps of more than 5 keyframes
        if (not self.localization_only and n_valid > 5 and n_free > 2
                and self.frame_id - self.last_kf_frame_id > 2
                and (n_bird_matched < 0.7 * n_bird_avail
                     or (n_bird_matched < 10 and n_bird_avail > 10))
                and int(f.bird_kp_valid.sum()) >= 20):
            m = tr.insert_keyframe(m, f, tr.TrackObs(no_front, bres_idx), Tcw, cfg,
                                   self.frame_id, slot=slot, device=self.device)
            self.map = m
            self.last_kf_slot = slot
            self.last_kf_frame_id = self.frame_id
            n_valid += 1

        # relocalization: BoW group candidates, PnP against each in turn
        # (Tracking.cc:2231-2392)
        if n_valid >= 2:
            words = vocab.word_ids(f.desc_pm1)
            members, accs = lc.relocalize_group_candidates(m, words, cfg, f.kp_valid)
            h = torch.cat([members.to(torch.float32), accs]).tolist()
            n_top = members.shape[0]
            tried = set()
            for cand, acc in zip(h[:n_top], h[n_top:]):
                cand = int(cand)
                if acc <= 0.05 or cand in tried:
                    continue
                tried.add(cand)
                Tcw_r, mp_idx, _, ok = lc.relocalize_against(
                    m, f.desc_pm1, words, cfg, f.uv, f.kp_valid, cand, self._ransac_noise(F))
                if not bool(ok):
                    continue
                out = tr.pose_opt_step(m, f, tr.TrackObs(mp_idx, torch.full_like(bres_idx, -1)),
                                       cfg, Tcw_r)
                n_in = int(out.n_inliers)
                if n_in >= 15:
                    self.state = tr.OK
                    self._reloc_frame_id = self.frame_id
                    self.last_route, self.last_inliers = "relocalized", n_in
                    self.last_assoc = tr.TrackObs(torch.where(out.front_inlier, mp_idx, -1),
                                                  torch.full_like(bres_idx, -1))
                    self._record(f, out.Tcw, False)
                    return out.Tcw

        # re-initialization against the last frame, odometry-seeded
        res = tr.match_for_init(self.last_frame, f, cfg)
        if int(res.count) >= cfg.tracking.min_init_matches and n_free > 2:
            T21_odom = self._odom_T21(self.last_frame, f)
            uv2 = tr._matched_uv2(self.last_frame, f, res)
            out = init_mod.reinitialize(cfg.camera, self.last_frame.uv, uv2, res.ok, T21_odom,
                                        self._gumbel(1, res.ok.shape[0])[0])
            if not bool(out.success) and cfg.flags.have_bird \
                    and cfg.tracking.min_bird_init_matches > 0:
                # the bird-seeded re-init: at small baselines the epipolar
                # re-init has no parallax; bird keypoints carry metric 3D
                out = tr.bird_seeded_init(self.last_frame, f, cfg, res)[0]
            if bool(out.success):
                m, slot = self._append_reinit_pair(m, self.last_frame, f, out, res)
                self.map = m
                self.state = tr.OK
                self._reloc_frame_id = self.frame_id
                self.last_route, self.last_inliers = "reinitialized", None
                Tcw = m.kf_Tcw[slot]
                self.last_kf_slot = slot
                self.last_kf_frame_id = self.frame_id
                self.last_assoc = tr.TrackObs(m.kf_mp[slot], m.kf_bird_mp[slot])
                self.ref_kf_tracked = int(torch.sum((m.kf_mp[slot] >= 0).to(torch.int32)))
                self._record(f, Tcw, True)
                return Tcw
        self._record(f, Tcw, False)
        self.last_assoc = tr.TrackObs(no_front, torch.full_like(bres_idx, -1))
        return Tcw

    def _append_reinit_pair(self, m: ms.MapState, f1: Frame, f2: Frame,
                            init_out: init_mod.InitResult, match_res):
        """``CreateReInitialMapPoints`` (``Tracking.cc:1056-1159``): a keyframe
        pair that starts a new submap, its first keyframe at the dead-reckoned
        last pose, with the pair's triangulated points.  The second keyframe's
        ``kf_mp`` row is written through the matched features only (the JAX
        package routes the other rows to feature F-1, and a match of that
        feature can lose its write there; ROADMAP, queue 3).  Returns (map,
        the second keyframe's slot)."""
        dev = m.kf_Tcw.device
        i32 = torch.int32
        Tcw1 = self.last_Tcw
        Tcw2 = se3.compose(init_out.T21, Tcw1)
        # the first two free slots in one host read (the caller saw > 2 free)
        slot1, slot2 = torch.sort(m.kf_valid.to(torch.int8), stable=True).indices[:2].tolist()
        m = tr._write_kf(m, slot1, f1, Tcw1, True, self.frame_id - 1)
        m = tr._write_kf(m, slot2, f2, Tcw2, False, self.frame_id)
        Xw = se3.transform(se3.inverse(Tcw1), init_out.Xw)
        F = f1.uv.shape[0]
        ok = match_res.ok & init_out.triangulated
        dest, can = ms.alloc_slots(m.mp_valid, ok)
        m = ms.reset_point_slots(m, dest, can, m.kf_seq[slot1])
        feat2 = match_res.idx.clamp(0, F - 1)
        f2l = feat2.long()
        put = lambda x, values: ms.put_rows(x, dest, can, values)
        kf_mp = m.kf_mp.clone()
        kf_mp[slot1] = torch.where(can, dest, -1)
        kf_mp[slot2] = ms.put_rows(torch.full((F,), -1, dtype=i32, device=dev), feat2, can, dest)
        m = m._replace(
            mp_pos=put(m.mp_pos, Xw), mp_desc=put(m.mp_desc, f2.desc[f2l]),
            mp_desc_pm1=put(m.mp_desc_pm1, f2.desc_pm1[f2l]),
            mp_valid=put(m.mp_valid, torch.ones_like(can)),
            mp_ref_kf=put(m.mp_ref_kf, torch.full((F,), slot2, dtype=i32, device=dev)),
            n_mp=(m.n_mp + torch.sum(can.to(i32))).to(i32),
            kf_mp=kf_mp)
        feats1 = torch.arange(F, dtype=i32, device=dev)
        m = ms.add_observation(m, dest, tr._slot_tensor(slot1, dev), feats1, can)
        return ms.add_observation(m, dest, tr._slot_tensor(slot2, dev), feat2, can), slot2

    def finish(self):
        """Drain asynchronous mapping and merge its last result (the
        reference's ``Shutdown`` joins its threads, ``System.cc:363-382``); a
        no-op in the synchronous mode."""
        if self._pipeline is not None:
            self._pipeline.flush()
            self._consume_pending()

    def close(self):
        """``finish()``, then stop the mapping pipeline's worker."""
        self.finish()
        if self._pipeline is not None:
            self._pipeline.close()

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
        self.ref_kf_tracked = 0
        self.n_lost_frames = 0
        self.loop_closer = lc.LoopCloser(self.cfg)
        self.loop_closer.tracer = self.tracer

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
