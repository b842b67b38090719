# Frozen copy of fishbirdeyevisualslam_torch/config.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Unified typed configuration: the port's own copy of
``fishbirdeyevisualslam_tpu/config.py`` (same dataclasses, field names and
defaults), so the port imports nothing of the JAX package.

The C++ reference scatters configuration over three tiers (SURVEY.md §5): an OpenCV
YAML settings file (``Examples/Monocular/fisheye.yaml``), compile-time constants
(camera↔base extrinsics in ``src/Frame.cc:1015-1047``, IPM scale & vehicle geometry in
``src/Frame.cc:39-44``, BA weights in ``include/Optimizer.h:65-68``), and five
file-scope behavior globals (``src/System.cc:30-34``).  Here all of it is one frozen
dataclass tree: frozen and hashable, passed explicitly to every function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Front fisheye camera intrinsics (reference ``Examples/Monocular/fisheye.yaml:8-16``).

    The fisheye follows OpenCV's ``cv::fisheye`` (equidistant, Kannala-Brandt k1..k4)
    model, which the reference uses for undistortion (``src/Frame.cc:638-669``).
    """

    fx: float = 348.5
    fy: float = 347.0
    cx: float = 480.0
    cy: float = 302.0
    # cv::fisheye distortion coefficients (named k1,k2,p1,p2 in the yaml but fed to
    # cv::fisheye::undistortPoints as k1..k4, src/Frame.cc:657).
    k1: float = -0.0488316
    k2: float = 0.000298406
    k3: float = -0.00591118
    k4: float = 0.00193258
    fps: float = 25.0
    width: int = 950   # 1900x800 crop, 0.5x downsample (mono_encoder.cc:153-158)
    height: int = 400


@dataclasses.dataclass(frozen=True)
class BirdConfig:
    """Bird's-eye IPM constants (reference ``src/Frame.cc:39-44``) and image geometry."""

    pixel2meter: float = 0.03984
    meter2pixel: float = 25.1
    rear_axle_to_center: float = 1.393
    vehicle_length: float = 4.63
    vehicle_width: float = 1.901
    rows: int = 384
    cols: int = 384
    # Ground-plane gating heights (ORBmatcher.cc:1701 |z|>0.2m; filterSize 0.05m
    # in BirdMapPointMatch, ORBmatcher.cc:1763-1902).
    plane_gate: float = 0.2
    filter_size: float = 0.05
    # Multiplier on filter_size for the live BirdMapPointMatch 3D gate.  The
    # reference gates at 1x (ORBmatcher.cc:1886); our bird keypoints come from
    # subpixel FAST on the IPM render whose prediction error under a 1-frame
    # odometry prior can exceed 5 cm.  Sweep via
    # scripts/robustness_eval.py --bird-gate-mult (results in STATUS.md).
    filter_gate_mult: float = 3.0


@dataclasses.dataclass(frozen=True)
class ExtrinsicsConfig:
    """Front-camera ↔ base-footprint extrinsics (reference ``src/Frame.cc:1015-1047``).

    Quaternion is (x, y, z, w) exactly as hard-coded there; it is normalized before
    use.  ``t_bc`` is the camera origin in the base frame.
    """

    q_bc_xyzw: Tuple[float, float, float, float] = (0.631, -0.623, 0.325, -0.330)
    t_bc: Tuple[float, float, float] = (3.747, 0.040, 0.736)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extraction parameters (reference ``fisheye.yaml:29-42``, ``src/Frame.cc:337``)."""

    n_features: int = 2000       # per-view budget (front and bird each)
    n_features_init: int = 4096  # doubled during initialization
                                 # (Tracking.cc:127-133; 4096 = aligned pad of 4000)
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 15        # (0..255 absolute intensity threshold)
    min_th_fast: int = 5
    patch_size: int = 31
    half_patch: int = 15
    edge_threshold: int = 19
    grid_cell: int = 32          # cell size for per-cell top-k selection (quadtree analog)

    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    def inv_level_sigma2(self) -> Tuple[float, ...]:
        # mvInvLevelSigma2 in the reference: 1 / scale^2 per octave.
        return tuple(1.0 / (self.scale_factor ** (2 * i)) for i in range(self.n_levels))


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor-matching thresholds (reference ``src/ORBmatcher.cc:38-40``)."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9
    nn_ratio_reloc: float = 0.75


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle-adjustment weights and schedules.

    Defaults wF=1, wB=1, wP=3 from ``include/Optimizer.h:65-68``; odometry chain edge
    information 1e4*wP / skip-1 2e3 / skip-2 1e3*wP from ``src/Optimizer.cc:2419-2495``;
    chi2 gates from ``src/Optimizer.cc:611-612`` (front 1.5 in pose opt, bird 5.991)
    and 5.991 in BA; pose-opt schedule 4 rounds x 10 iters (``Optimizer.cc:613``),
    local BA 5 + 10 iters (``Optimizer.cc:2511-2572``).
    """

    w_front: float = 1.0
    w_bird: float = 1.0
    w_pose: float = 3.0
    odom_info_chain: float = 1.0e4
    odom_info_skip1: float = 2.0e3
    odom_info_skip2: float = 1.0e3
    chi2_mono_pose: float = 1.5
    chi2_mono_ba: float = 5.991
    chi2_bird: float = 5.991
    huber_delta: float = math.sqrt(5.991)
    pose_rounds: int = 4
    pose_iters: int = 10
    # soft odometry prior in per-frame pose optimization (EXTENSION: the
    # reference uses the odometry pose only as the LM seed; 0 = reference
    # behavior).  Anchors frames with weak visual constraints.
    pose_prior_info: float = 100.0
    local_ba_iters_1: int = 5
    local_ba_iters_2: int = 10
    global_ba_iters: int = 20
    essential_graph_min_feat: int = 100


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking policy constants (reference ``src/Tracking.cc``)."""

    min_init_matches: int = 100       # SearchForInitialization gate (Tracking.cc:864)
    # bird-seeded init fallback (EXTENSION, slam.tracking.bird_seeded_init):
    # minimum 3D-consistent bird matches to bootstrap a map from the bird view
    # when both front inits fail; 0 disables the fallback
    min_bird_init_matches: int = 40
    min_track_matches: int = 20       # motion-model match gate
    min_inliers_ok: int = 30          # TrackLocalMap success (relaxed 10 after reloc)
    max_local_keyframes: int = 80     # local map KF cap (Tracking.cc:2175)
    bird_window_meters: float = 5.0   # bird sliding window (Tracking.cc:2644-2721)
    min_kfs_for_reset: int = 5        # full reset if lost early (Tracking.cc:731-740)
    # covisible neighbors searched by local mapping: triangulation + fuse run
    # against the top-N covisibility neighbors of the new KF (the reference
    # uses 20 for mono CreateNewMapPoints / SearchInNeighbors,
    # LocalMapping.cc:231-246,478-490).  10 covers real-sequence covisibility
    # spans at half the reference's match cost (round-2 verdict flagged 5 as
    # under-triangulating on wide spans); mapping runs only at keyframes, so
    # the extra pairs are off the per-frame hot path.
    mapping_neighbors: int = 10
    # SearchForInitialization matches level-0 keypoints only in the reference
    # (ORBmatcher.cc:406,419); matching across all levels finds more init
    # support on the low-texture synthetic renders but carries more
    # spurious-init risk on real imagery.  Pinned True by the port's config.reference_parity().
    init_level0_only: bool = False
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 25   # = fps
    # Frame::isInFrustum gates (dist within [0.8 d_min, 1.2 d_max], viewing
    # cos > 0.5) and the predicted-level octave window in local-map matching
    # (``Frame.cc:435-491``).  Round 1 shipped these OFF because they starved
    # tracking; the root cause was fresh landmarks (stats pass not yet run):
    # their zero normal failed viewcos > 0.5 and their unestimated scale range
    # saturated the predicted level, so the whole young map was gated out.
    # Fresh points are now exempt from both gates until their stats exist, and
    # the reference defaults hold.
    use_frustum_gates: bool = True
    use_level_window: bool = True
    # Route projection-gated matching through the fused projection-match
    # kernels (ops/cuda_matcher.py) when the frame lies on a CUDA device: the
    # (N_feat, N_points) distance matrix never reaches device memory.  On the
    # CPU the dense op-graph path runs.
    use_fused_matcher: bool = True
    # Candidate compaction for the fused matchers: gather the visible
    # candidate rows into a fixed-cap prefix before the kernel when they fit,
    # so the (N_feat x N_points) kernel shrinks to (N_feat x cap).  The full
    # axis runs when the visible count exceeds the cap (identical results by
    # construction).  0 disables.
    # cap sizing: soak r4 probes measured local windows up to 3374 front /
    # 2614 bird landmarks at full keyframe capacity and ~2k motion-model
    # candidates; the caps sit just above those so the compact path engages
    # in production while denser moments fall back to the full axis
    match_compact_cap: int = 2048        # motion-model match (last-frame cands)
    local_match_compact_cap: int = 4096  # local-map match (covis window cands)
    bird_match_compact_cap: int = 4096
    # loop acceptance: the candidate's covisibility-neighborhood map points
    # must reproject onto the current KF with >= this many 10 px descriptor
    # matches under the computed correction (``LoopClosing.cc:380-400``)
    loop_min_proj_matches: int = 40
    # EXTENSION (r4): vet accepted loops against the wheel-odometry relative
    # pose (corrected SE2 cand->cur must agree within 0.05*path + 0.5 m).
    # The reference never exploits its odometry stream for loop vetting; on
    # repetitive synthetic ground texture the projection count alone aliased
    # (3 false loops in the r4 soak).  Pinned False by the port's config.reference_parity().
    loop_odom_vet: bool = True
    # EXTENSION (r4): landmark capacity-pressure valve — when free point
    # slots drop below 1/16 of capacity, retire the lowest-value eighth of
    # the landmarks outside the covisibility window so triangulation can
    # always allocate (tracking.relieve_point_pressure).  The reference grows
    # unbounded in RAM and has no such regime.  Pinned False by
    # the port's config.reference_parity().
    point_pressure_valve: bool = True
    # EXTENSION (r4): proactive LOST-path keyframe eviction — when free KF
    # slots drop to <= 2 while LOST (re-init's headroom gate can never pass),
    # evict least-connected keyframes so recovery isn't wedged forever.
    # Pinned False by the port's config.reference_parity().  The reactive slot-famine fallbacks
    # at keyframe insertion are NOT gated: there the alternative is dropping
    # the keyframe outright, a larger deviation from the (unbounded)
    # reference than evicting the least-connected one.
    lost_eviction_valve: bool = True


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed array capacities for the struct-of-arrays map state.

    Dynamic structures in the reference (STL containers + pointer graphs) become
    capacity-padded arrays with validity masks (SURVEY.md §7 design stance).
    """

    max_keyframes: int = 256
    # landmark capacities sized for a ~200 m excursion at full retention
    # (soak r4: a 175 m course's retained multi-obs landmarks overflowed
    # 16384/8192 and allocation starved; relieve_point_pressure is the
    # overflow valve beyond these)
    max_points: int = 32768
    max_bird_points: int = 16384
    max_obs_per_point: int = 16
    max_front_kp: int = 2048          # per-frame front keypoints (pad of n_features)
    max_bird_kp: int = 2048
    max_local_kfs: int = 32           # local BA window (optimized KFs)
    max_local_observers: int = 32     # fixed observer KFs kept in local BA
    max_local_points: int = 4096      # front landmarks in the local BA problem
    # 8192: the r5 700-frame dense-KF soak peaked at 9553 in-window bird
    # landmarks (5457 clipped at the old 4096)
    max_local_bird_points: int = 8192


@dataclasses.dataclass(frozen=True)
class FlagsConfig:
    """The five behavior globals compiled into the reference (``src/System.cc:30-34``)."""

    tight_couple: bool = True    # odometry SE3 edges in local BA
    tight_couple2: bool = True   # + skip-1 / skip-2 odometry edges
    loose_couple: bool = True    # odometry motion prior + init scale
    fix_scale: bool = True       # loop closing optimizes SE3, not Sim3
    have_bird: bool = True       # entire bird's-eye pipeline


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = CameraConfig()
    bird: BirdConfig = BirdConfig()
    extrinsics: ExtrinsicsConfig = ExtrinsicsConfig()
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    ba: BAConfig = BAConfig()
    tracking: TrackingConfig = TrackingConfig()
    capacity: CapacityConfig = CapacityConfig()
    flags: FlagsConfig = FlagsConfig()

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SystemConfig()


