"""The benchmark's own instruments, put around the port's module attributes
for one run and taken off after it: the program looks these functions up
at each call, so a wrapper sees every call the main path makes.

* Captures for the correctness check: on the window frames drawn from the
  seed and on the frame before each, the Frame that ``build_frame``
  returned and the tracking core's results with the map it returned (cloned,
  since later frames update it); on the drawn frames also the core's
  arguments (the map only where the frame before was not a plain tracked
  frame: elsewhere the check works the handoff out itself), and the local
  mapping step's input map and result.
* Host spans (``--trace 1``): the host time of each call into
  ``tracking.track_frame_core`` and ``tracking.local_mapping_step``, as
  ``SlamSystem._track_ok`` makes them; each also opens a
  ``torch.profiler.record_function`` so that the device trace's idle gaps
  can be put down to it.
* Launch records (``--trace 1``, while the profiler runs): the shapes of each
  call into the wrappers of the port's kernels, for ``counts.py``.
* Host syncs (``--trace 1``): those that ``torch.cuda.set_sync_debug_mode``
  warns of, a lower bound, as ``chip_smoke.py:count_syncs`` counts them.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import warnings

import torch

from portbench import counts


def clone_tuple(tup):
    """A NamedTuple with every tensor field cloned."""
    return type(tup)(*[x.clone() if isinstance(x, torch.Tensor) else x for x in tup])


class Probes:
    def __init__(self, check: set, trace: bool):
        self.check = set(check)
        self.prior = {j - 1 for j in self.check}   # the frames before them
        self.trace = trace
        self.frame = None          # the window frame being tracked, None outside the window
        self.captures = {}         # window frame -> dict
        self.spans = {"core": [0, 0.0], "mapping": [0, 0.0]}
        self.recording = False     # launch records on (the profiled slice)
        self.launches = []         # (kernel, (bytes, ops, peak)) or deferred counts
        self._restore = []

    # ------------------------------------------------------------- install
    def _wrap(self, module, name, make):
        orig = getattr(module, name)
        # the wrapper carries the function's attributes (the kernel wrappers
        # count their launches on themselves)
        setattr(module, name, functools.update_wrapper(make(orig), orig))
        self._restore.append((module, name, orig))

    def install(self):
        from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch
        from fishbirdeyevisualslam_torch.slam import system as system_mod
        from fishbirdeyevisualslam_torch.slam import tracking
        from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
        self._wrap(system_mod, "build_frame", self._build_frame)
        self._wrap(tracking, "track_frame_core", self._core)
        self._wrap(tracking, "local_mapping_step", self._mapping)
        if self.trace:
            self._wrap(cuda_fast, "fast_detect_levels", self._rec_fast)
            self._wrap(cuda_patch, "extract_patches", self._rec_patch)
            self._wrap(cuda_matcher, "fused_projection_match", self._rec_match("proj_match"))
            self._wrap(cuda_matcher, "fused_projection_match_dual",
                       self._rec_match("proj_match_dual"))
            self._wrap(cuda_pose_opt, "pose_optimization", self._rec_pose)
            self._wrap(cuda_matcher, "hamming_matrix_packed", self._rec_hamming)
        return self

    def remove(self):
        for module, name, orig in reversed(self._restore):
            setattr(module, name, orig)
        self._restore = []

    def _cap(self, prior: bool = True) -> dict | None:
        """The capture of the frame being tracked, where it is drawn (or,
        with ``prior``, the frame before one that is)."""
        if self.frame is None or not (self.frame in self.check
                                      or prior and self.frame in self.prior):
            return None
        cap = self.captures.setdefault(self.frame, {})
        cap["checked"] = self.frame in self.check
        return cap

    def mark(self, j: int, plain: bool):
        """Record whether window frame ``j`` was a plain tracked frame (the
        core's route, OK, no keyframe), after ``track`` returned it."""
        if j in self.captures:
            self.captures[j]["plain"] = plain

    # ------------------------------------------------------------ wrappers
    def _build_frame(self, orig):
        def build_frame(*args, **kw):
            f = orig(*args, **kw)
            cap = self._cap()
            if cap is not None and "frame" not in cap:
                cap["frame"] = f
            return f
        return build_frame

    @contextlib.contextmanager
    def _span(self, name):
        """Host time of the call, outside the profiled slice (the profiler
        slows the host there)."""
        if not self.trace:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        if not self.recording:
            acc = self.spans[name]
            acc[0] += 1
            acc[1] += time.perf_counter() - t0

    def _core(self, orig):
        def track_frame_core(m, f, cfg, Tcw_pred, cand_last, ref_kf=None, last_f=None,
                             last_bp_idx=None, last_Tcw=None, bird_maint_enabled=True,
                             device=None):
            cap = self._cap()
            if cap is not None and "core_out" not in cap and cap["checked"]:
                # after a plain tracked frame the check works the handoff out
                # itself, from the map the core returned there
                handed = (self.captures.get(self.frame - 1, {}).get("plain", False)
                          and cfg.flags.loose_couple)
                cap["core_in"] = dict(
                    m=None if handed else clone_tuple(m), Tcw_pred=Tcw_pred.clone(),
                    cand_last=cand_last.clone(), ref_kf=ref_kf,
                    last_f=None if last_f is None else clone_tuple(last_f),
                    last_bp_idx=None if last_bp_idx is None else last_bp_idx.clone(),
                    last_Tcw=None if last_Tcw is None else last_Tcw.clone(),
                    bird_maint_enabled=bird_maint_enabled)
            elif cap is not None and "core_out" in cap:
                cap = None
            with self._span("core"):
                out = orig(m, f, cfg, Tcw_pred, cand_last, ref_kf, last_f, last_bp_idx,
                           last_Tcw, bird_maint_enabled, device)
            if cap is not None:
                cap["core_out"] = dict(Tcw=out.Tcw.clone(), mp_idx=out.mp_idx.clone(),
                                       bp_idx=out.bp_idx.clone(), map=clone_tuple(out.map))
            return out
        return track_frame_core

    def _mapping(self, orig):
        def local_mapping_step(m, new_kf, cfg, n_neighbors, device=None):
            cap = self._cap(prior=False)
            if cap is not None and "map_in" not in cap:
                cap["map_in"] = dict(m=clone_tuple(m), slot=int(new_kf), n_nb=int(n_neighbors))
            else:
                cap = None
            with self._span("mapping"):
                out = orig(m, new_kf, cfg, n_neighbors, device)
            if cap is not None:
                cap["map_out"] = clone_tuple(out)
            return out
        return local_mapping_step

    # --------------------------------------------------------- launch records
    def _rec_fast(self, orig):
        def fast_detect_levels(levels, th_hi, th_lo):
            if self.recording:
                self.launches.append(("fast", counts.fast_counts(levels)))
            return orig(levels, th_hi, th_lo)
        return fast_detect_levels

    def _rec_patch(self, orig):
        def extract_patches(img, yx, side):
            if self.recording:
                # the distinct pixels read need a host read: counted after the slice
                self.launches.append(("patch", (img, yx.clone(), side)))
            return orig(img, yx, side)
        return extract_patches

    def _rec_match(self, kernel):
        def make(orig):
            def match(pm1_a, *args, **kw):
                if self.recording:
                    self.launches.append(
                        (kernel, counts.projection_match_counts(pm1_a.shape[0], args[3].shape[0])))
                return orig(pm1_a, *args, **kw)
            return match
        return make

    def _rec_pose(self, orig):
        def pose_optimization(cam, ba, Tcw0, front, bird, *args, **kw):
            if self.recording:
                self.launches.append(("pose_opt", (front.valid.clone(), bird.valid.clone(),
                                                   ba.pose_rounds, ba.pose_iters)))
            return orig(cam, ba, Tcw0, front, bird, *args, **kw)
        return pose_optimization

    def _rec_hamming(self, orig):
        def hamming_matrix_packed(desc_a, desc_b):
            if self.recording:
                self.launches.append(("hamming", counts.hamming_counts(desc_a.shape[0],
                                                                       desc_b.shape[0])))
            return orig(desc_a, desc_b)
        return hamming_matrix_packed

    def launch_least_s(self) -> float:
        """The least time of every launch recorded, in seconds (reads the
        deferred counts on the host: call after the profiled slice)."""
        total = 0.0
        for kernel, c in self.launches:
            if kernel == "patch":
                c = counts.patch_counts(*c)
            elif kernel == "pose_opt":
                fv, bv, rounds, iters = c
                c = counts.pose_opt_counts(fv.numel(), bv.numel(), int(fv.sum()), int(bv.sum()),
                                           rounds, iters)
            total += counts.least_s(*c)
        return total


@contextlib.contextmanager
def count_syncs(out: list):
    """Append to ``out`` the host syncs of the calling thread in the block
    that ``torch.cuda.set_sync_debug_mode("warn")`` warns of: a lower bound,
    since that detector does not see every synchronising operation."""
    n = [0]
    me = threading.get_ident()

    def seen(message, *_args, **_kwargs):
        if "synchroniz" in str(message) and threading.get_ident() == me:
            n[0] += 1

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings():   # restores showwarning on exit
        warnings.simplefilter("always")
        warnings.showwarning = seen
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    out.append(n[0])


def cpu_reading(start: float | None = None, window_s: float | None = None) -> float:
    """This process's CPU seconds (all its threads); with ``start``, their
    share of the window's wall: near 1 where the host loop never waits, so
    a slower pace is the host's CPU running the same work slower."""
    now = time.process_time()
    return now if start is None else (now - start) / window_s
