#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``fishbirdeyevisualslam_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py                 # all phases (one card, nvcc)
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --profile       # all phases + the profiled frame's op table
    python3 chip_smoke.py --facade-only   # build + phase 5 (the facade drive) only
    python3 chip_smoke.py --recovery-only # build + phase 6 (recovery) only
    python3 chip_smoke.py --loop-only     # build + phase 7 (loop closing) only
    python3 chip_smoke.py --async-only    # build + phases 8 and 9 and the dataset check only
    python3 chip_smoke.py --flags-only    # build + phase 10 (switches, contour, demo, odometer) only
    python3 chip_smoke.py --parallel-only # build + phase 11 (sharded BA, batched kernel 5, ...) only
    python3 chip_smoke.py --realism-only  # build + the 80-frame realism drive only (not in the default run)

Phases, each printing its lines:
  1. the card and the toolchain; the kernels built from
     fishbirdeyevisualslam_torch/csrc/ (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with the device time of both (CUDA graph replays timed by
     CUDA events) and the kernel's own device time (the profiler's device
     activities of the port's own kernels over the same replays): FAST, the
     patch gather (also at the initialization budget, 4096 windows) and both
     projection matchers; the fused pose optimisation on a stream frame's own
     inputs and on a synthetic problem, timed at (rounds, iters) = (1, 0),
     (1, 10) and (4, 10); the packed Hamming matrix and masked match at
     scripts/bench_matcher.py's shapes, the masked match also with every
     target in one 100 px square, each launch's own time printed beside
     two bounds (the window test on every pair, and what the inputs need);
  3. the per-frame slice (build_frame + track_frame_core) at full width
     with the default SystemConfig, a 32-frame stream (each frame under fresh
     sensor noise, the map and the last frame carried over), with each
     kernel's launch count over that stream, and one frame under
     torch.profiler (device activities and busy share);
  4. the stream's next frame through the kernels' plain versions, and its
     tracking through the CPU's dense route, each compared with the kernels;
  5. the entry point, SlamSystem(cfg, device=card).track, over a 30-frame arc
     drive rendered by io/synthetic.py at full width (in a process pool, as
     are the drives of phases 6 and 7): two-view initialization,
     tracking, keyframes and the synchronous local mapping step; the
     initialization's frame and route, each frame's state, per keyframe the
     synchronised times of both mapping stages, host syncs, window sizes and
     point counts, the tracer's spans, the host syncs of a tracked frame, the
     kernel launches over the drive and the ATE (bound 0.15 m); the init pair
     held against the port's CPU facade with the same draws; the last
     keyframe's mapping step held against the CPU and run twice on the card
     (bit-identical); then reset() with a re-initialization, and
     localization mode, on a second facade over the same drive, as
     tests/test_system_modes.py drives them;
  6. recovery: the facade over a 42-frame render of the arc, whose tracking
     is lost on frame 12 (each frame's state, route and inliers; no frame
     may raise, every pose finite, the first LOST spell over within 3
     frames; kernels 4 and 5 launched on the LOST frames), then a copy of
     phase 5's facade after 14 frames kidnapped as tests/test_reloc.py does
     (18 m and 0.3 rad), which must relocalize on frame 6 within 1.0 m of
     its own estimate;
  7. loop closing: the facade over tests/test_loop_closing.py's 160-frame
     rectangle (odometry noise 0.02) with an ATE under that test's 0.5 m;
     every loop candidate tried (inliers, projected matches, odometry vet)
     and each closure's stage times.  The JAX package closes no loop on this
     render (its odometry vet turns every candidate down), so the correction
     runs on the drive's first closure or else on its first candidate past
     the RANSAC and the projection gate, closed from its inputs with the vet
     off: twice on the card (bit-identical), once on the CPU with the same
     draws (the same candidate, poses within 1e-3, front points p99 <= 1.0
     px), and its global BA and essential graph profiled;
  8. asynchronous mapping (SlamSystem(async_mapping=True): the native
     pipeline's worker maps a snapshot on a CUDA stream of its own) over
     phase 5's render: flushed after every frame, bit-identical to phase 5's
     synchronous drive (map and trajectory); free-running, with each frame's
     state, the jobs, journal, bird replay, frames tracked during a job,
     host syncs by thread, kernel launches by stream, the tracking thread's
     frame wall with and without a job in flight, and the ATE (bound 0.3 m);
     synchronous and asynchronous frames/s over the first 20 frames,
     alternated three times;
  9. phase 5's facade saved after 15 frames (io/session.py), loaded and
     driven to the end, against the uninterrupted drive (bound 1e-4); the arc
     with fix_scale = False (ATE bound 0.3 m); phase 7's correction under
     fix_scale = False (the Sim3 correct_loop), twice on the card
     (bit-identical) and on the CPU (phase 7's bounds), its stages timed;
     then phase 5's render exported as PGM and read back through the native
     prefetcher, exact;
 10. the switches, each drive at tests/e2e_common.py's reduced capacity (K =
     64, P = 8192, PB = 4096) and held to its JAX heavy test's bound:
     have_bird, tight_couple and loose_couple off and reference_parity() over
     the 10-frame arc; 8 keyframe slots and a keyframe every 2 frames over a
     36-frame arc; 12 degraded frames with their contour images; then the
     port's demo (default config, contour on, 10 frames, its files under a
     temporary prefix, ATE < 0.15 m), the bird odometer (NDT and ICP) on the
     card against its CPU route, and filter_ipm_edges on the card against
     the CPU.  Each drive prints its states, routes, ATE, keyframes and
     synchronised ms per frame;
 11. the multi-device layer (parallel/sharded_ba.py): the landmark-sharded
     global BA at full width (io/fixtures.py:make_realistic_map, K = 256, P =
     32768, PB = 16384, M = 16, 5 + 10 iterations) over a one-rank NCCL group,
     bit-identical to bundle_adjust, and over two processes on the one card
     (gloo carrying CUDA tensors, scripts/torch_multiprocess_ba_worker.py),
     the ranks equal and within 5e-2 of one rank; the entry point
     batched_pose_optimization over 16 problems of phase 2's shape, one
     launch of kernel 5 over the batch, bit-identical to 16 single launches
     and each row within phase 2's bounds of the plain LM, timed against the
     16 single launches; match_map_points_dual on phase 3's map equal to the
     ids form and the plain matcher; extract equal to each view of
     extract_dual.
``--realism-only`` drives tests/test_realism.py's 80-frame model-violating
circle (at least 50 frames OK, ATE < 0.25 m); it is not in the default run.
Then the script's wall time, the kernel table as one JSON line (launches
summed over the drives of phases 5-10; the batched pose kernel's over phase
11's batched_pose_optimization), the card's name and power limit, and
the device line.  Any failed check exits non-zero.  Needs no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import warnings

# numpy's OpenBLAS on one thread: the drives' renders (small matrix-vector
# products over every pixel) run in RENDER_WORKERS processes, and OpenBLAS's
# own threads in each of them made the render 2x slower than serial
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402

T_START = time.perf_counter()

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 4_000_000  # ~2 ms of a spinning kernel ahead of each timed loop
N_STREAM = 32
N_PHASE = 8   # frames timed phase by phase after the stream
NOISE = 2.0  # grey levels of per-frame sensor noise on the stream's images
# packed Hamming kernels: queries, targets, window radius (scripts/bench_matcher.py)
HAMMING_SHAPE = (2048, 16384, 50.0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def own_kernel_names() -> list:
    """The ``__global__`` functions of the port's CUDA sources: the device
    activities that count as a kernel's own time."""
    from fishbirdeyevisualslam_torch import _cuda
    names = []
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                            src.read_text())
    return names


def time_ms(torch, fn, iters: int = 20, own: bool = False, warmup: int = 3, out=None):
    """Device time of ``fn`` in ms: its launches captured once in a CUDA graph
    (after ``warmup`` calls), then the median of ``iters`` replays, each timed
    by CUDA events.  A plain call would time the host's Python between the
    events as well, which at these sizes is longer than the kernels.  With
    ``own``, returns (that time, {kernel: ms per replay}) where the second
    sums the profiler's device time of the port's own kernels over ``iters``
    more replays: the wrapper's preparation ops and allocations are in the
    first number only.  ``out``, a list, receives the last warm-up call's
    result."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            res = fn()
    torch.cuda.current_stream().wait_stream(side)
    if out is not None:
        out.append(res)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    # keep the card busy while the host enqueues the timed replays, so that a
    # replay shorter than the host's launch latency is not timed with the card
    # waiting for it
    torch.cuda._sleep(SLEEP_CYCLES)
    evs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in evs)
    if not own:
        return ms
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\b(" + "|".join(own_kernel_names()) + r")\b")
    for _attempt in range(3):  # a pass that saw none of the port's kernels is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                graph.replay()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        per = {}
        for e in device:
            m = pat.search(e.name)
            if m:
                per[m.group(1)] = per.get(m.group(1), 0.0) + e.device_time / 1e3 / iters
        if per:
            return ms, per
        print(f"[kernel-own] the profiler saw {len(device)} device activities, none of the "
              f"port's kernels: {sorted({e.name[:60] for e in device})[:5]}", flush=True)
    fail("the profiler saw none of the port's kernels in the graph replays")


def own_line(label: str, ms: float, per: dict) -> str:
    parts = " + ".join(f"{k} {v:.4f}" for k, v in per.items())
    return (f"[kernel-own] {label}: wrapper graph {ms:.4f} ms, kernels' own "
            f"{sum(per.values()):.4f} ms ({parts})")


def time_row(torch, row: dict, label: str, fn) -> None:
    """A kernel row's wrapper graph time (``ms``) and its kernels' own time
    (``kernel_ms``), with the line that reports both."""
    row["ms"], per = time_ms(torch, fn, own=True)
    row["kernel_ms"] = sum(per.values())
    print(own_line(label, row["ms"], per), flush=True)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def images(cfg, seed: int):
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    out = []
    for h, w in ((cfg.camera.height, cfg.camera.width), (cfg.bird.rows, cfg.bird.cols)):
        img = gaussian_filter(rng.rand(h, w), 1.5)
        out.append(((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32))
    return out


def window_pixels(torch, atlas, yx, side: int) -> int:
    """Distinct atlas pixels that the gather's windows cover, with the corners
    clamped as the gather clamps them: what it must read at least."""
    h, w = atlas.shape
    y, x = yx[:, 0].long(), yx[:, 1].long()
    y = torch.where(y < 0, y + h, y).clamp(0, h - side)
    x = torch.where(x < 0, x + w, x).clamp(0, w - side)
    ar = torch.arange(side, device=atlas.device)
    idx = ((y[:, None] + ar)[:, :, None] * w + (x[:, None] + ar)[:, None, :]).reshape(-1)
    hit = torch.zeros(h * w, dtype=torch.bool, device=atlas.device)
    hit[idx] = True
    return int(hit.sum())


@contextlib.contextmanager
def plain_kernels():
    """Point the kernel wrappers' module attributes at their plain versions,
    so that the main path, which looks them up at each call, runs without the
    kernels: the reference the kernels are held against on the card."""
    from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    swaps = [(cuda_fast, "fast_detect_levels"), (cuda_patch, "extract_patches"),
             (cuda_matcher, "fused_projection_match"),
             (cuda_matcher, "fused_projection_match_dual"),
             (cuda_pose_opt, "pose_optimization")]
    saved = [getattr(mod, name) for mod, name in swaps]
    try:
        for mod, name in swaps:
            setattr(mod, name, getattr(mod, name + "_plain"))
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_kernels(torch, cfg, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch, features
    from fishbirdeyevisualslam_torch.ops import image as image_ops
    from fishbirdeyevisualslam_torch.slam.frame import build_frame

    rows = {}
    timed = functools.partial(time_row, torch)
    front, bird = (torch.from_numpy(x).to(dev) for x in images(cfg, 0))
    orb = cfg.orb
    levels = (image_ops.build_pyramid(front, orb.n_levels, orb.scale_factor)
              + image_ops.build_pyramid(bird, orb.n_levels, orb.scale_factor))
    th = (float(orb.ini_th_fast), float(orb.min_th_fast))
    got = cuda_fast.fast_detect_levels(levels, *th)
    ref = cuda_fast.fast_detect_levels_plain(levels, *th)
    err, exact = 0.0, True
    for (s, r), (s0, r0) in zip(got, ref):
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(r, r0, rtol=1e-5, atol=1e-4)
        err = max(err, float((s - s0).abs().max()), float((r - r0).abs().max()))
        exact = exact and torch.equal(s, s0) and torch.equal(r, r0)
    px = sum(l.numel() for l in levels)
    b_ms, b_by = bound(px * 12, px * 16 * 6, PEAK_F32)
    rows["fast"] = dict(
        name="fast_detect_levels", source="fishbirdeyevisualslam_torch/csrc/fast.cu",
        replaces="fishbirdeyevisualslam_tpu/ops/pallas_fast.py:125",
        max_abs_err=err, plain_ms=time_ms(torch, lambda: cuda_fast.fast_detect_levels_plain(
            levels, *th)), bound_ms=b_ms, bound_by=b_by, library_ms=None)
    timed(rows["fast"], "fast_detect_levels", lambda: cuda_fast.fast_detect_levels(levels, *th))
    print(f"[kernel] FAST+NMS: {len(levels)} levels, {px} px, max_abs_err {err:.3g} "
          f"({'bit-exact' if exact else 'not bit-exact'}), "
          f"{rows['fast']['ms']:.4f} ms (plain {rows['fast']['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}; bytes {px * 12}, ops {px * 96})", flush=True)

    # patch gather: the front view's atlas and 2048 selected corners of a real frame
    maps = got[: orb.n_levels]
    budgets = image_ops.per_level_budget(cfg.capacity.max_front_kp, orb.n_levels,
                                         orb.scale_factor)
    sels = [features._detect_level(s, r, orb, budgets[l]) for l, (s, r) in enumerate(maps)]
    side = features.PATCH37
    atlas, yx = features.level_atlas(levels[: orb.n_levels], [s[0] for s in sels])
    if not torch.equal(cuda_patch.extract_patches(atlas, yx, side),
                       cuda_patch.extract_patches_plain(atlas, yx, side)):
        fail("patch gather differs from its plain version")
    n = yx.shape[0]
    read_px = window_pixels(torch, atlas, yx, side)
    nbytes = read_px * 4 + yx.numel() * 4 + n * side * side * 4
    b_ms, b_by = bound(nbytes, 0, PEAK_F32)
    rows["patch"] = dict(
        name="extract_patches", source="fishbirdeyevisualslam_torch/csrc/patch.cu",
        replaces="fishbirdeyevisualslam_tpu/ops/pallas_patch.py:50", max_abs_err=0.0,
        plain_ms=time_ms(torch, lambda: cuda_patch.extract_patches_plain(atlas, yx, side)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    timed(rows["patch"], "extract_patches", lambda: cuda_patch.extract_patches(atlas, yx, side))
    print(f"[kernel] patch gather: N={n} side={side}, exact, {rows['patch']['ms']:.4f} ms "
          f"(plain {rows['patch']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
          f"bytes {nbytes}: {read_px} distinct atlas px read of {atlas.numel()})", flush=True)

    # the same gather at the initialization budget (n_features_init = 4096
    # windows), which the facade's frames run until it initializes
    budgets = image_ops.per_level_budget(orb.n_features_init, orb.n_levels, orb.scale_factor)
    sels = [features._detect_level(s, r, orb, budgets[l]) for l, (s, r) in enumerate(maps)]
    atlas4, yx4 = features.level_atlas(levels[: orb.n_levels], [s[0] for s in sels])
    if not torch.equal(cuda_patch.extract_patches(atlas4, yx4, side),
                       cuda_patch.extract_patches_plain(atlas4, yx4, side)):
        fail("patch gather differs from its plain version at the init budget")
    init = dict(n=yx4.shape[0],
                plain_ms=time_ms(torch, lambda: cuda_patch.extract_patches_plain(atlas4, yx4,
                                                                                 side)))
    timed(init, "extract_patches at the init budget",
          lambda: cuda_patch.extract_patches(atlas4, yx4, side))
    read4 = window_pixels(torch, atlas4, yx4, side)
    init["bound_ms"], b4_by = bound(read4 * 4 + yx4.numel() * 4 + yx4.shape[0] * side * side * 4,
                                    0, PEAK_F32)
    rows["patch"]["init_budget"] = init
    print(f"[kernel] patch gather at the init budget: N={yx4.shape[0]} side={side}, exact, "
          f"graph {init['ms']:.4f} ms, kernel's own {init['kernel_ms']:.4f} ms (plain "
          f"{init['plain_ms']:.4f} ms, bound {init['bound_ms']:.4f} ms by {b4_by}; {read4} "
          f"distinct atlas px read)", flush=True)

    # projection matchers: a real frame's 2048 descriptors against 4096 targets,
    # half of them the frame's own descriptors with a few bits flipped
    f = build_frame(front, bird, torch.full(bird.shape, 255.0, device=dev), torch.zeros(3),
                    0.0, cfg, cfg.capacity.max_front_kp, None, cfg.capacity.max_bird_kp,
                    device=dev)
    rng = np.random.RandomState(1)
    na, nb = f.desc_pm1.shape[0], 4096
    src = rng.randint(0, na, nb)
    flip = torch.from_numpy(np.where(rng.rand(nb, 256) < 0.05, -1.0, 1.0)).to(dev)
    pm1_b = (f.desc_pm1.float()[src] * flip).to(torch.bfloat16)
    pm1_b[nb // 2:] = torch.from_numpy(np.where(rng.rand(nb - nb // 2, 256) > 0.5, 1.0, -1.0)
                                       ).to(dev).bfloat16()
    pm1_b = pm1_b.contiguous()
    uv_b = (f.uv[src] + torch.from_numpy(rng.randn(nb, 2).astype(np.float32) * 4).to(dev))
    radius = torch.from_numpy((15.0 * 1.2 ** rng.randint(0, 3, nb)).astype(np.float32)).to(dev)
    pred = torch.from_numpy(rng.randint(-1, 8, nb).astype(np.int32)).to(dev)
    valid_b = torch.from_numpy(rng.rand(nb) > 0.05).to(dev)
    prob = (f.desc_pm1, f.uv, f.octave, f.kp_valid, pm1_b, uv_b, radius, pred, valid_b)
    th = float(cfg.matcher.th_high)
    n_ok = 0
    for lw in (False, True):
        for ratio in (None, 0.8):
            got = cuda_matcher.fused_projection_match(*prob, max_dist=th, level_window=lw,
                                                      ratio=ratio)
            ref = cuda_matcher.fused_projection_match_plain(*prob, max_dist=th,
                                                            level_window=lw, ratio=ratio)
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                fail(f"projection match (level_window={lw}, ratio={ratio}) differs")
            n_ok = max(n_ok, int(got.count))
        got = cuda_matcher.fused_projection_match_dual(*prob, max_dist=th, level_window=lw)
        ref = cuda_matcher.fused_projection_match_dual_plain(*prob, max_dist=th,
                                                             level_window=lw)
        if not all(torch.equal(x, y) for g, r in zip(got, ref) for x, y in zip(g, r)):
            fail(f"dual projection match (level_window={lw}) differs")
    if n_ok < 500:
        fail(f"the matcher problem found only {n_ok} matches")
    flops = 2.0 * na * nb * 256
    nbytes = (na + nb) * 512 + na * 16 + nb * 20 + na * 9 * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    for key, fn, plain, kw, label in (
            ("match", cuda_matcher.fused_projection_match,
             cuda_matcher.fused_projection_match_plain, dict(level_window=True),
             "fused_projection_match"),
            ("match_dual", cuda_matcher.fused_projection_match_dual,
             cuda_matcher.fused_projection_match_dual_plain, dict(level_window=True),
             "fused_projection_match_dual")):
        rows[key] = dict(
            name=label, source="fishbirdeyevisualslam_torch/csrc/matcher.cu",
            replaces=("fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:335" if key == "match"
                      else "fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:425"),
            max_abs_err=0.0, plain_ms=time_ms(torch, lambda: plain(*prob, max_dist=th, **kw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        timed(rows[key], label, lambda: fn(*prob, max_dist=th, **kw))
        print(f"[kernel] {label}: {na}x{nb}, level window on/off, ratio None/0.8: exact "
              f"({n_ok} matches), {rows[key]['ms']:.4f} ms (plain {rows[key]['plain_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms by {b_by}; flops {flops:.3g}, bytes {nbytes})",
              flush=True)
    return rows


def pose_problem(torch, cfg, dev, n: int, nb: int, seed: int, outlier_frac: float = 0.1):
    """tests/test_pallas_pose_opt.py:make_problem at n front and nb bird
    observations: points seen from a known pose, 0.5 px pixel noise, the
    first ``outlier_frac`` of the pixels moved 30-80 px, 1 cm bird noise.
    Returns (true pose, FrontObs, BirdObs) on ``dev``."""
    from fishbirdeyevisualslam_torch.geometry import camera, se3
    from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
    rng = np.random.RandomState(seed)
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    T_true = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.3, -0.1, 0.2]))
    uv = camera.project_pinhole(cfg.camera, se3.transform(T_true, torch.from_numpy(Xw))).numpy()
    uv += rng.randn(n, 2).astype(np.float32) * 0.5
    n_out = int(outlier_frac * n)
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2)).astype(np.float32)
    Xb = np.stack([rng.uniform(2, 12, nb), rng.uniform(-5, 5, nb), np.zeros(nb)],
                  -1).astype(np.float32)
    Xc = se3.transform(T_true, torch.from_numpy(Xb)).numpy()
    Xc += rng.randn(nb, 3).astype(np.float32) * 0.01
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    return (T_true.to(dev), FrontObs(t(Xw), t(uv), t(np.ones(n)), ones(n)),
            BirdObs(t(Xb), t(Xc), t(np.ones(nb)), ones(nb)))


def pose_diff(a, b) -> float:
    """Max abs of the se3 log of a * b^-1."""
    from fishbirdeyevisualslam_torch.geometry import se3
    return se3.log(se3.compose(a.cpu(), se3.inverse(b.cpu()))).abs().max().item()


def phase_pose_and_hamming(torch, cfg, dev, st):
    """Kernel 5 (the fused pose optimisation) against its plain version on a
    frame's real associations from the stream and on a synthetic problem with
    outliers, prior off and on; kernels 6 and 7 (packed Hamming) against
    theirs at scripts/bench_matcher.py's shapes, exactly, and kernel 7 also
    on clustered targets."""
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.ops import cuda_matcher, matcher
    from fishbirdeyevisualslam_torch.slam.frame import desc_pm1_from_packed
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt

    rows = {}
    timed = functools.partial(time_row, torch)
    # the stream's first frame, with the inputs of both pose optimisations recorded
    calls = []
    wrapper = cuda_pose_opt.pose_optimization

    def record(cam, ba, Tcw0, front, bird, prior_T=None, prior_info=0.0):
        calls.append((Tcw0, front, bird, prior_T, prior_info))
        return wrapper(cam, ba, Tcw0, front, bird, prior_T, prior_info)

    record.launches = 0  # the wrapper counts on its module attribute, swapped meanwhile
    cuda_pose_opt.pose_optimization = record
    try:
        st.step(st.start, 0)
    finally:
        cuda_pose_opt.pose_optimization = wrapper
    if len(calls) != 2:
        fail(f"one tracked frame ran {len(calls)} pose optimisations, not 2")
    T_true, front, bird = pose_problem(torch, cfg, dev, cfg.capacity.max_front_kp,
                                       cfg.capacity.max_bird_kp, 0)
    T_pert = se3.retract(T_true, torch.tensor([0.01, 0, -0.01, 0.05, 0.02, 0], device=dev))
    cases = [(f"stream call {i + 1}", c) for i, c in enumerate(calls)] + [
        ("synthetic, prior 0", (se3.identity(device=dev), front, bird, None, 0.0)),
        ("synthetic, prior 100", (T_pert, front, bird, T_pert, 100.0))]
    err = 0.0
    for label, (T0, fo, bo, pT, info) in cases:
        got = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0, fo, bo, pT, info)
        ref = cuda_pose_opt.pose_optimization_plain(cfg.camera, cfg.ba, T0, fo, bo, pT, info)
        d = pose_diff(got.Tcw, ref.Tcw)
        ff = (got.front_inlier != ref.front_inlier).float().mean().item()
        bf = (got.bird_inlier != ref.bird_inlier).float().mean().item()
        dn = abs(int(got.n_inliers) - int(ref.n_inliers))
        print(f"[kernel] pose_optimization, {label}: N={fo.valid.shape[0]} "
              f"({int(fo.valid.sum())} valid), NB={bo.valid.shape[0]} "
              f"({int(bo.valid.sum())} valid), prior_info {info}: pose diff {d:.3g}, "
              f"inlier flips {ff:.4f} / {bf:.4f}, n_inliers {int(got.n_inliers)} vs "
              f"{int(ref.n_inliers)}", flush=True)
        if not (d <= 1e-3 and ff < 0.02 and bf < 0.02 and dn <= 5):
            fail(f"pose optimisation ({label}) differs from its plain version")
        err = max(err, d)
    if pose_diff(cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, se3.identity(
            device=dev), front, bird).Tcw, T_true) > 5e-3:
        fail("the pose kernel missed the synthetic problem's true pose")
    # time it on the stream's second call (after the local-map match)
    T0, fo, bo, pT, info = calls[1]
    n_f, n_b = int(fo.valid.sum()), int(bo.valid.sum())
    evals = cfg.ba.pose_rounds * (cfg.ba.pose_iters + 1)
    # per active observation and evaluation: transform, residual, Jacobian,
    # 21 + 6 weighted sums (~200 flops); per re-gate ~35 flops per observation
    ops = evals * (n_f + n_b) * 200 + cfg.ba.pose_rounds * (fo.valid.numel()
                                                             + bo.valid.numel()) * 35
    nbytes = fo.valid.numel() * (6 * 4 + 1 + 1) + bo.valid.numel() * (7 * 4 + 1 + 1) + 7 * 4 * 3
    b_ms, b_by = bound(nbytes, ops, PEAK_F32)
    rows["pose_opt"] = dict(
        name="pose_optimization", source="fishbirdeyevisualslam_torch/csrc/pose_opt.cu",
        replaces="fishbirdeyevisualslam_tpu/solvers/pallas_pose_opt.py:387", max_abs_err=err,
        plain_ms=time_ms(torch, lambda: cuda_pose_opt.pose_optimization_plain(
            cfg.camera, cfg.ba, T0, fo, bo, pT, info)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the fixed cost and the cost per evaluation: the same call at (rounds, iters)
    # = (1, 0), (1, 10) and the main path's (4, 10)
    for r, i in ((1, 0), (1, 10), (cfg.ba.pose_rounds, cfg.ba.pose_iters)):
        ba = dataclasses.replace(cfg.ba, pose_rounds=r, pose_iters=i)
        label = f"pose_optimization (rounds, iters) = ({r}, {i}), {r * (i + 1)} evaluations"
        if (r, i) == (cfg.ba.pose_rounds, cfg.ba.pose_iters):
            timed(rows["pose_opt"], label, lambda: cuda_pose_opt.pose_optimization(
                cfg.camera, ba, T0, fo, bo, pT, info))
        else:
            ms, per = time_ms(torch, lambda: cuda_pose_opt.pose_optimization(
                cfg.camera, ba, T0, fo, bo, pT, info), own=True)
            print(own_line(label, ms, per), flush=True)
    print(f"[kernel] pose_optimization: {rows['pose_opt']['ms']:.4f} ms (plain "
          f"{rows['pose_opt']['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}; ops {ops}, "
          f"bytes {nbytes}; {evals} evaluations, each reduced across a cluster of 8 SMs)",
          flush=True)

    # packed Hamming at scripts/bench_matcher.py's shapes
    na, nb, radius = HAMMING_SHAPE
    rng = np.random.RandomState(0)
    words = lambda k: torch.from_numpy(rng.randint(0, 2**32, (k, 8), dtype=np.uint64)
                                       .astype(np.uint32).view(np.int32)).to(dev)
    da, db = words(na), words(nb)
    uva = torch.from_numpy(rng.uniform(0, 900, (na, 2)).astype(np.float32)).to(dev)
    uvb = torch.from_numpy(rng.uniform(0, 900, (nb, 2)).astype(np.float32)).to(dev)
    vb = torch.ones(nb, dtype=torch.bool, device=dev)
    # forced ties: query q's own descriptor at its position in three columns,
    # across the kernel's slots, items and chunks
    ties = ((0, (300, 700, nb // 2 + 8)), (1, (5, 6)), (2, (nb - 1, nb // 4 + 1)))
    for q, cols in ties:
        for c in cols:
            db[c], uvb[c] = da[q], uva[q]
    if not torch.equal(cuda_matcher.hamming_matrix_packed(da, db),
                       cuda_matcher.hamming_matrix_packed_plain(da, db)):
        fail("hamming_matrix_packed differs from its plain version")
    # the clustered problem: every target but the tie columns in one 100 px square
    uvc = torch.from_numpy(np.random.RandomState(1).uniform(400, 500, (nb, 2))
                           .astype(np.float32)).to(dev)
    tie_cols = torch.tensor([c for _, cols in ties for c in cols], device=dev)
    uvc[tie_cols] = uvb[tie_cols]
    n_cand = {}
    for label, uvt, valid in (("uniform", uvb, vb), ("clustered", uvc, vb),
                              ("uniform, no valid target", uvb, torch.zeros_like(vb))):
        got = cuda_matcher.fused_masked_match(da, uva, db, uvt, valid, radius)
        ref = cuda_matcher.fused_masked_match_plain(da, uva, db, uvt, valid, radius)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            fail(f"fused_masked_match ({label}) differs from its plain version")
        if "no valid" in label:
            if int((got[2] != -1).sum()):
                fail("fused_masked_match matched with no valid target")
            continue
        if got[2][:3].tolist() != [min(c) for _, c in ties] or got[1][:3].tolist() != [0.0] * 3:
            fail(f"fused_masked_match ({label}) broke a tie wrongly: {got[2][:3].tolist()}")
        n_cand[label] = int((matcher.window_mask(uva, uvt, radius) & valid[None, :]).sum())
    print(f"[kernel] packed Hamming: {na}x{nb}, radius {radius}: matrix exact; masked match "
          f"exact (best, second, idx) uniform and clustered, ties to the lowest column, "
          f"no-valid-target case all -1; pairs in the window: {n_cand}", flush=True)
    pa, pb = desc_pm1_from_packed(da), desc_pm1_from_packed(db)
    b_ms, b_by = bound((na + nb) * 32 + na * nb * 4, na * nb * 8 * 3, PEAK_F32)
    rows["hamming"] = dict(
        name="hamming_matrix_packed", source="fishbirdeyevisualslam_torch/csrc/hamming.cu",
        replaces="fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:43", max_abs_err=0.0,
        plain_ms=time_ms(torch, lambda: cuda_matcher.hamming_matrix_packed_plain(da, db)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: (256.0 - torch.matmul(pa, pb.T).float()) * 0.5))
    timed(rows["hamming"], "hamming_matrix_packed",
          lambda: cuda_matcher.hamming_matrix_packed(da, db))
    print(f"[kernel] hamming_matrix_packed: {rows['hamming']['ms']:.4f} ms (plain "
          f"{rows['hamming']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; +/-1 bf16 "
          f"matmul yardstick {rows['hamming']['library_ms']:.4f} ms)", flush=True)
    # two bounds: the dense one (the window test on every pair, ~6 ops, what
    # a kernel without binning must do) and what these inputs need (XOR +
    # popcount + add on the 8 words of each pair that passes and the top-2
    # update, ~4 ops; each input byte read once and each output byte written
    # once)
    nbytes = na * (32 + 8) + nb * (32 + 8 + 1) + na * 12
    for label, uvt in (("uniform", uvb), ("clustered", uvc)):
        need_ops = n_cand[label] * (8 * 3 + 4)
        dense_ms, dense_by = bound(nbytes, na * nb * 6 + need_ops, PEAK_F32)
        need_ms, need_by = bound(nbytes, need_ops, PEAK_F32)
        row = dict(
            name="fused_masked_match", source="fishbirdeyevisualslam_torch/csrc/hamming.cu",
            replaces="fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:130", max_abs_err=0.0,
            plain_ms=time_ms(torch, lambda: cuda_matcher.fused_masked_match_plain(
                da, uva, db, uvt, vb, radius)),
            bound_ms=need_ms, bound_by=need_by, dense_bound_ms=dense_ms, library_ms=None)
        timed(row, f"fused_masked_match, {label}",
              lambda: cuda_matcher.fused_masked_match(da, uva, db, uvt, vb, radius))
        print(f"[kernel] fused_masked_match, {label}: graph {row['ms']:.4f} ms, kernels' own "
              f"{row['kernel_ms']:.4f} ms (plain {row['plain_ms']:.4f} ms); dense bound "
              f"{dense_ms:.5f} ms by {dense_by} ({dense_ms / row['kernel_ms']:.1%} of own), "
              f"needed bound {need_ms:.5f} ms by {need_by} ({need_ms / row['kernel_ms']:.1%} "
              f"of own); {n_cand[label]} pairs pass, ops {need_ops}, bytes {nbytes}",
              flush=True)
        if label == "uniform":
            rows["masked_match"] = row
        else:
            rows["masked_match"]["clustered"] = row
    return rows


def full_width_map(torch, cfg, f0, dev):
    """The map of bench.py:40-89 at the default capacities (random points,
    descriptors, 32 keyframes, 3072 observed points), with *_desc_pm1 derived
    from *_desc, and the first frame's own keypoints written over its first
    rows so that the matches, pose optimisations and bird maintenance do real
    work.  Unlike bench.py's map, which is never carried from frame to frame,
    this one is: its bird points are observed by two keyframes each, so the
    per-frame cull keeps them, and a quarter of the bird slots are free, as
    culling leaves them in a running map, so bird maintenance can create
    points.  Returns (map, the frame's keypoint -> point association)."""
    from fishbirdeyevisualslam_torch.slam import map_state as ms
    from fishbirdeyevisualslam_torch.slam.frame import desc_pm1_from_packed
    cap = cfg.capacity
    P, PB, K = cap.max_points, cap.max_bird_points, min(cap.max_keyframes, 32)
    F = cap.max_front_kp
    rng = np.random.RandomState(0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    m = ms.empty_map(cfg, device=dev)
    mp_pos = np.stack([rng.uniform(-10, 10, P), rng.uniform(-5, 5, P),
                       rng.uniform(5, 40, P)], -1).astype(np.float32)
    mp_desc = rng.randint(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    bp_pos = np.stack([rng.uniform(0, 25, PB), rng.uniform(-12, 12, PB),
                       np.zeros(PB)], -1).astype(np.float32)
    bp_desc = rng.randint(0, 2**32, (PB, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    mp_max = np.full(P, 60.0, np.float32)
    mp_min = np.full(P, 1.0, np.float32)
    # the frame's own keypoints at random depths (pose: identity)
    fv = f0.kp_valid.cpu().numpy()
    rows = np.nonzero(fv)[0]
    n = len(rows)
    z = rng.uniform(4, 30, n).astype(np.float32)
    uv = f0.uv.cpu().numpy()[rows]
    c = cfg.camera
    mp_pos[:n] = np.stack([(uv[:, 0] - c.cx) * z / c.fx, (uv[:, 1] - c.cy) * z / c.fy, z], -1)
    mp_desc[:n] = f0.desc.cpu().numpy()[rows]
    mp_max[:n] = np.linalg.norm(mp_pos[:n], axis=-1) * 1.2 ** (
        f0.octave.cpu().numpy()[rows] - 0.5)
    mp_min[:n] = mp_max[:n] / 1.2 ** 7
    brows = np.nonzero(f0.bird_kp_valid.cpu().numpy())[0]
    brows = brows[: len(brows) // 2]
    bp_pos[: len(brows)] = f0.bird_cam.cpu().numpy()[brows]
    bp_desc[: len(brows)] = f0.bird_desc.cpu().numpy()[brows]
    bp_valid = np.arange(PB) < PB * 3 // 4
    bobs_kf = m.bobs_kf.clone()
    bobs_kf[:, 0] = torch.arange(PB, device=dev) % K
    bobs_kf[:, 1] = (torch.arange(PB, device=dev) + 1) % K
    bobs_valid = m.bobs_valid.clone()
    bobs_valid[:, :2] = t(bp_valid)[:, None]
    obs_kf = m.obs_kf.clone()
    obs_valid = m.obs_valid.clone()
    obs_kf[:3072, 0] = torch.arange(3072, device=dev) % K
    obs_valid[:3072, 0] = True
    obs_kf[:n, 0] = 0
    assoc = np.full(F, -1, np.int32)
    assoc[rows] = np.arange(n)
    kf_mp = m.kf_mp.clone()
    kf_mp[0] = t(assoc)
    mp_desc_t, bp_desc_t = t(mp_desc), t(bp_desc)
    return m._replace(
        mp_pos=t(mp_pos), mp_desc=mp_desc_t, mp_desc_pm1=desc_pm1_from_packed(mp_desc_t),
        mp_valid=torch.ones(P, dtype=torch.bool, device=dev), mp_max_dist=t(mp_max),
        mp_min_dist=t(mp_min), bp_pos=t(bp_pos), bp_desc=bp_desc_t,
        bp_desc_pm1=desc_pm1_from_packed(bp_desc_t), bp_valid=t(bp_valid),
        bobs_kf=bobs_kf, bobs_valid=bobs_valid,
        kf_valid=torch.arange(cap.max_keyframes, device=dev) < K,
        kf_seq=torch.where(torch.arange(cap.max_keyframes, device=dev) < K,
                           torch.arange(cap.max_keyframes, device=dev), -1).int(),
        n_kf=torch.tensor(K, dtype=torch.int32, device=dev),
        kf_counter=torch.tensor(K, dtype=torch.int32, device=dev),
        n_bp=torch.tensor(int(bp_valid.sum()), dtype=torch.int32, device=dev),
        obs_kf=obs_kf, obs_valid=obs_valid, kf_mp=kf_mp), t(assoc)


def profile_frame(torch, run_frame, table: bool) -> int:
    """One frame under torch.profiler: device activities, device busy time
    and, with ``table``, the ops that cost the host most.  Returns the number
    of device activities."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"[profile] one frame: {wall:.1f} ms wall (profiled), {len(kernels)} device "
          f"activities, device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of the wall time)",
          flush=True)
    if table:
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    return len(kernels)


class Stream:
    """The tracked stream as ``SlamSystem._track_ok`` drives it: each frame
    is the map's own scene under fresh sensor noise (its seed is the frame's
    index), the candidates are the last frame's associations and the
    reference keyframe's points, the prediction is the last pose (the
    odometry stands still), and the map, the last frame and its bird
    associations carry over.  The first prediction is off by a small
    motion, which the pose optimisations take out."""

    def __init__(self, torch, cfg, dev, n_frames: int):
        from fishbirdeyevisualslam_torch.geometry import se3
        from fishbirdeyevisualslam_torch.slam import tracking as tr
        from fishbirdeyevisualslam_torch.slam.frame import build_frame
        self.torch, self.cfg, self.dev, self.tr, self.build_frame = torch, cfg, dev, tr, \
            build_frame
        cap = cfg.capacity
        self.F, self.FB = cap.max_front_kp, cap.max_bird_kp
        front_np, bird_np = images(cfg, 0)
        self.front = torch.from_numpy(front_np).to(dev)
        self.bird = torch.from_numpy(bird_np).to(dev)
        self.bmask = torch.full(self.bird.shape, 255.0, device=dev)
        self.zeros3 = torch.zeros(3, device=dev)
        f0 = self._frame(self.front, self.bird, 0.0)
        m, assoc = full_width_map(torch, cfg, f0, dev)
        # frame i's noise: made on the card in bulk, before any timing
        self.noise = []
        for i in range(n_frames):
            g = torch.Generator(device=dev).manual_seed(1000 + i)
            self.noise.append((NOISE * torch.randn(self.front.shape, generator=g, device=dev),
                               NOISE * torch.randn(self.bird.shape, generator=g, device=dev)))
        T0 = se3.exp(torch.tensor([0.002, -0.001, 0.0015, 0.03, -0.02, 0.04], device=dev))
        # (map, last frame, last front / bird associations, last pose, prediction)
        self.start = (m, f0, assoc, torch.full((self.FB,), -1, dtype=torch.int32, device=dev),
                      se3.identity(device=dev), T0)

    def _frame(self, front, bird, ts: float):
        return self.build_frame(front, bird, self.bmask, self.zeros3, ts, self.cfg, self.F,
                                None, self.FB, device=self.dev)

    def build(self, i: int):
        nf, nb = self.noise[i]
        return self._frame(self.front + nf, self.bird + nb, float(i))

    def track(self, state, f, device=None):
        m, f_last, last_mp, last_bp, T_last, T_pred = state
        cand = self.torch.cat([last_mp, m.kf_mp[0]])
        return self.tr.track_frame_core(m, f, self.cfg, T_pred, cand, 0,
                                        self.tr.bird_only_view(f_last), last_bp, T_last,
                                        True, device=device or self.dev)

    @staticmethod
    def advance(f, out):
        return (out.map, f, out.mp_idx, out.bp_idx, out.Tcw, out.Tcw)

    def step(self, state, i: int):
        f = self.build(i)
        out = self.track(state, f)
        return out, self.advance(f, out)


def phase_slice(torch, cfg, dev, st, profile: bool = False):
    """The per-frame slice at full width: a 32-frame stream."""
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt

    cap = cfg.capacity
    F, FB = cap.max_front_kp, cap.max_bird_kp
    state = st.start
    for i in range(3):  # warm-up from the start state: caches, allocator, cuBLAS handles
        st.step(state, i)
    torch.cuda.synchronize()
    on_path = (cuda_fast.fast_detect_levels, cuda_patch.extract_patches,
               cuda_matcher.fused_projection_match_dual, cuda_matcher.fused_projection_match,
               cuda_pose_opt.pose_optimization)
    counters = on_path + (cuda_matcher.hamming_matrix_packed, cuda_matcher.fused_masked_match)
    for c in counters:
        c.launches = 0
    outs = []
    t0 = time.perf_counter()
    for i in range(N_STREAM):
        out, state = st.step(state, i)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"[slice] {N_STREAM} frames at full width (front {cfg.camera.width}x"
          f"{cfg.camera.height}, bird {cfg.bird.cols}x{cfg.bird.rows}, {F}+{FB} keypoints, "
          f"P={cap.max_points} PB={cap.max_bird_points} K={cap.max_keyframes} "
          f"M={cap.max_obs_per_point}): {N_STREAM / dt:.2f} frames/s, "
          f"{dt / N_STREAM * 1e3:.2f} ms/frame", flush=True)
    print(f"[slice] kernel launches over the stream: {json.dumps(launches)}", flush=True)
    for c in on_path:
        if launches[c.__name__] == 0:
            fail(f"{c.__name__} was never launched on the main path")
    for name, per_frame in (("fast_detect_levels", 1), ("fused_projection_match_dual", 1),
                            ("fused_projection_match", 3), ("pose_optimization", 2)):
        if launches[name] != per_frame * N_STREAM:
            fail(f"{name} launched {launches[name]} times over the stream, not {per_frame} per "
                 "frame")
    sc = torch.stack([o.scalars for o in outs]).cpu().numpy()
    n_bp = torch.stack([o.map.n_bp for o in outs]).cpu().numpy()
    print(f"[slice] over the stream, min/max: n_motion {sc[:, 0].min()}/{sc[:, 0].max()}, "
          f"n_inliers {sc[:, 1].min()}/{sc[:, 1].max()}, n_bird {sc[:, 4].min()}/"
          f"{sc[:, 4].max()}, bird points in the map {n_bp.min()}/{n_bp.max()}", flush=True)

    # per-phase times (synchronised around each phase) and host syncs per frame
    ph_b, ph_t = [], []
    for i in range(N_STREAM, N_STREAM + N_PHASE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f = st.build(i)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = st.track(state, f)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state = st.advance(f, out)
        ph_b.append((t2 - t1) * 1e3)
        ph_t.append((t3 - t2) * 1e3)
    i_last = N_STREAM + N_PHASE
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        st.step(state, i_last)
    torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(x.message) for x in w)
    print(f"[slice] per phase (median of {N_PHASE}, synchronised): build_frame "
          f"{statistics.median(ph_b):.2f} ms, track_frame_core {statistics.median(ph_t):.2f} ms;"
          f" host syncs per frame: {syncs}", flush=True)

    # the outputs: finite, of the expected shapes, real work done on every frame
    out = outs[-1]
    s = out.scalars.cpu().numpy()
    print(f"[slice] last frame's scalars [n_motion, n_inliers, nref3, nref2, n_bird, "
          f"n_ref_bird, n_kfs] = {s.tolist()}; Tcw = "
          f"{np.round(out.Tcw.cpu().numpy(), 5).tolist()}", flush=True)
    if out.Tcw.shape != (7,) or not all(bool(torch.isfinite(o.Tcw).all()) for o in outs):
        fail("pose not finite")
    if out.mp_idx.shape != (F,) or out.bp_idx.shape != (FB,) or s.shape != (7,):
        fail("output shapes")
    if sc[:, 0].min() < 200 or sc[:, 1].min() < 200 or sc[:, 4].min() < 100:
        fail(f"the slice tracked too little on some frame: min scalars {sc.min(0).tolist()}")
    d_id = se3.log(out.Tcw.cpu()).abs().max().item()
    if d_id > 1e-2:
        fail(f"the stream drifted from the map's pose: {d_id:.3g}")

    activities = profile_frame(torch, lambda: st.step(state, i_last), profile)

    def compare(label, got, ref):
        d = pose_diff(got.Tcw, ref.Tcw)
        same_mp = (got.mp_idx.cpu() == ref.mp_idx.cpu()).float().mean().item()
        same_bp = (got.bp_idx.cpu() == ref.bp_idx.cpu()).float().mean().item()
        print(f"[{label}] pose diff {d:.3g}, mp_idx equal {same_mp:.4f}, bp_idx equal "
              f"{same_bp:.4f}, scalars {got.scalars.tolist()} vs {ref.scalars.tolist()}",
              flush=True)
        if d > 1e-3 or same_mp < 0.99 or same_bp < 0.99:
            fail(f"{label}: the two disagree")

    # the stream's next frame, from its carried state, through the plain
    # versions on the card; no kernel may launch meanwhile
    n0 = [c.launches for c in counters]
    with plain_kernels():
        ref = st.step(state, i_last)[0]
    if [c.launches for c in counters] != n0:
        fail("a kernel launched while the plain versions were swapped in")
    f = st.build(i_last)
    got = st.track(state, f)
    compare("plain", got, ref)
    # the same frame's tracking on the CPU: the dense route the JAX package
    # runs off the TPU, against the card's fused route
    compare("cpu dense route", got, st.track(state, f, device=torch.device("cpu")))
    return launches, N_STREAM / dt, activities


N_MAP = 30          # frames of the facade drive (an arc, io/synthetic.py)
N_RESUME = 15       # phase 9: the facade's session saved after this many frames
N_BEFORE_RESET = 6  # the modes' drive (tests/test_system_modes.py): frames before reset(),
N_RESET = 8         # frames after it (re-initialization, then tracking),
N_LOCAL = 4         # frames in localization mode
MAP_STEP = 0.5      # metres per frame
ATE_BOUND = 0.15    # m: the JAX package's e2e bound (tests/test_e2e.py)
# px: the last keyframe's mapping step, card against CPU, p99 of the front
# points' reprojection difference in the keyframes that observe them; twice
# the largest reading of `chip_smoke.py --survey` over keyframes 4-28 of the
# drive (0.2192 px card against CPU, 0.4950 px one CPU thread against eight;
# PERF.md)
PX99_BOUND = 1.0


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sync_site(depth: int = 3) -> str:
    """The call site of a host sync: the innermost ``depth`` frames of the
    port's package (file:line function), the op's own line first."""
    frames = [f for f in traceback.extract_stack() if "fishbirdeyevisualslam_torch" in f.filename]
    return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                      for f in frames[::-1][:depth]) or "outside the port"


@contextlib.contextmanager
def count_syncs(torch, dev, out: list, sites=None):
    """Append to ``out`` the host syncs of the block that
    ``torch.cuda.set_sync_debug_mode`` warns of: a lower bound, since that
    detector does not see every synchronising operation.  ``sites`` (a
    ``collections.Counter``), where given, counts them by call site
    (``_sync_site``).  A block nested in another counts its own syncs, and
    the outer block does not see them.  Only the calling thread's syncs
    count (the mode is process-wide; the mapping worker's are phase 8's).
    On the CPU, nothing to count."""
    if dev.type != "cuda":
        yield
        out.append(0)
        return
    n = [0]
    me = threading.get_ident()

    def seen(message, *_args, **_kwargs):
        if "synchroniz" in str(message) and threading.get_ident() == me:
            n[0] += 1
            if sites is not None:
                sites[_sync_site()] += 1

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    out.append(n[0])


def map_diff(torch, cfg, a, b, new_kf: int) -> dict:
    """How far two maps after one mapping step are apart: keyframe fields
    equal, pose max |se3 log|, live front points, observations and bird
    points of each, the share of a's front points that b holds at the same
    slot with the same observations, and the 99th percentile of those
    points' position difference reprojected with b's poses into the
    keyframes that observe them (``px99``) and into the new keyframe
    (``px99_new``), in px; the same share for the bird points, and the 99th
    percentile and maximum of their position difference, in m.  The bound is
    on ``px99``, as the CPU parity tests compare points: a point seen from
    two close views is held only weakly in depth, and the last LM iterations
    move it along its rays by as much as the order of a reduction does, which
    ``px99_new`` shows for the points the new keyframe does not observe."""
    from fishbirdeyevisualslam_torch.device import to_device
    from fishbirdeyevisualslam_torch.geometry import camera, se3
    cpu = torch.device("cpu")
    a, b = to_device(a, cpu), to_device(b, cpu)
    p99 = lambda x: torch.quantile(x, 0.99).item() if x.numel() else 0.0
    uv = lambda T, X: camera.project_pinhole(cfg.camera, se3.transform(T, X))
    same = a.mp_valid & b.mp_valid & (a.obs_kf == b.obs_kf).all(1) \
        & (a.obs_feat == b.obs_feat).all(1) & (a.obs_valid == b.obs_valid).all(1)
    seen = same[:, None] & b.obs_valid
    pt = torch.nonzero(seen)[:, 0]
    T = b.kf_Tcw[b.obs_kf.long()[seen]]
    d_obs = (uv(T, a.mp_pos[pt]) - uv(T, b.mp_pos[pt])).abs().max(-1).values
    d_px = torch.zeros(a.mp_pos.shape[0]).index_reduce_(0, pt, d_obs, "amax")[seen.any(1)]
    d_new = (uv(b.kf_Tcw[new_kf], a.mp_pos[same])
             - uv(b.kf_Tcw[new_kf], b.mp_pos[same])).abs().max(-1).values
    bsame = a.bp_valid & b.bp_valid & (a.bobs_kf == b.bobs_kf).all(1) \
        & (a.bobs_feat == b.bobs_feat).all(1) & (a.bobs_valid == b.bobs_valid).all(1)
    d_m = (a.bp_pos[bsame] - b.bp_pos[bsame]).abs().max(-1).values
    share = lambda x, v: float(x.sum()) / max(int(v.sum()), 1)
    return dict(
        kf_same=torch.equal(a.kf_valid, b.kf_valid) and torch.equal(a.kf_seq, b.kf_seq),
        dT=se3.log(se3.compose(a.kf_Tcw, se3.inverse(b.kf_Tcw)))[a.kf_valid].abs().max().item(),
        counts=[int(x.sum()) for x in (a.mp_valid, b.mp_valid, a.obs_valid & a.mp_valid[:, None],
                                       b.obs_valid & b.mp_valid[:, None], a.bp_valid, b.bp_valid)],
        share=share(same, a.mp_valid), px99=p99(d_px), px99_new=p99(d_new),
        bshare=share(bsame, a.bp_valid), b99=p99(d_m),
        bmax=d_m.max().item() if d_m.numel() else 0.0)


def describe_diff(d: dict) -> str:
    c = d["counts"]
    return (f"keyframes equal {d['kf_same']}, pose diff {d['dT']:.3g}, live points / "
            f"observations / bird points {c[0]}/{c[1]}, {c[2]}/{c[3]}, {c[4]}/{c[5]}; "
            f"{d['share']:.4f} of the points at the same slot with the same observations, their "
            f"reprojection difference p99 {d['px99']:.4f} px in the keyframes that observe them "
            f"({d['px99_new']:.4f} px in the new keyframe); {d['bshare']:.4f} of the bird points "
            f"likewise, their position difference p99 {d['b99']:.3g} m, max {d['bmax']:.3g} m")


def mapping_step_diffs(torch, cfg, dev, m0, slot: int, n_nb: int, spread: bool = False):
    """One mapping step on ``m0`` for the keyframe at ``slot``, on ``dev``
    and on the CPU with all its threads and, with ``spread``, with one:
    (``map_diff`` of the card against the CPU, ``map_diff`` of one CPU thread
    against many or None, the CPU step's seconds)."""
    from fishbirdeyevisualslam_torch.device import to_device
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    cpu = torch.device("cpu")
    got = tr.local_mapping_step(to_device(m0, dev), slot, cfg, n_nb, device=dev)
    t1 = time.perf_counter()
    ref = tr.local_mapping_step(to_device(m0, cpu), slot, cfg, n_nb, device=cpu)
    t_cpu = time.perf_counter() - t1
    if not spread:
        return map_diff(torch, cfg, got, ref, slot), None, t_cpu
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = tr.local_mapping_step(to_device(m0, cpu), slot, cfg, n_nb, device=cpu)
    finally:
        torch.set_num_threads(threads)
    return map_diff(torch, cfg, got, ref, slot), map_diff(torch, cfg, one, ref, slot), t_cpu


def profile_call(torch, label: str, run, tables: bool = True) -> None:
    """One call of ``run`` (after a warm-up call) under torch.profiler: wall,
    device busy time and activities, and with ``tables`` the ops that cost
    the device and the host most."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"[profile] one {label}: {wall:.1f} ms wall (profiled), {len(kernels)} device "
          f"activities, device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of the wall time)",
          flush=True)
    if tables:
        ka = prof.key_averages()
        print(ka.table(sort_by="cuda_time_total", row_limit=12))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=12))


def profile_initialize(torch, cfg, dev, seq, ini: dict) -> None:
    """The two-view initializer on the drive's init pair under the profiler:
    ``initialize`` (both RANSACs, the decompositions, the census of 12
    hypotheses) on the pair's init-budget frames and their match."""
    from fishbirdeyevisualslam_torch.geometry import odometry, se3
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.frame import build_frame
    from fishbirdeyevisualslam_torch.solvers import initializer as init_mod
    f1, f2 = (build_frame(seq.frames[i]["front"], seq.frames[i]["bird"], seq.frames[i]["mask"],
                          seq.odom[i], seq.frames[i]["timestamp"], cfg, cfg.orb.n_features_init,
                          None, cfg.capacity.max_bird_kp, device=dev)
              for i in (ini["ref_frame"], ini["frame"]))
    res = tr.match_for_init(f1, f2, cfg)
    T21 = se3.inverse(odometry.preintegrate_cam(cfg.extrinsics, f1.odom, f2.odom))
    uv2 = tr._matched_uv2(f1, f2, res)
    draws = tuple(g.to(dev) for g in init_mod.GumbelDraws(7)(2, 200, res.ok.shape[0]))
    profile_call(torch, f"initialize ({res.ok.shape[0]} features, {int(res.count)} matches)",
                 lambda: init_mod.initialize(cfg.camera, f1.uv, uv2, res.ok, T21, draws))


@contextlib.contextmanager
def mapping_timers(torch, cfg, dev, rows: list, captured: dict, keep=()):
    """Wrap ``local_mapping_pre`` and ``local_mapping_ba`` (which the facade's
    ``local_mapping_step`` looks up at each call) with synchronised timers and
    host-sync counts: one row per keyframe in ``rows``, with the window's
    size and point counts; ``captured`` keeps the last keyframe's map before
    its step and its slot, and under ``"kept"`` a host copy of the map and the
    slot of each keyframe whose number (from 1) is in ``keep``."""
    from fishbirdeyevisualslam_torch.device import to_device
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    pre0, ba0 = tr.local_mapping_pre, tr.local_mapping_ba

    def pre(m, new_kf, cfg_, n_nb, device=None, counts=None):
        captured.update(m=m, slot=new_kf)
        if len(rows) + 1 in keep:
            captured.setdefault("kept", []).append(
                (len(rows) + 1, to_device(m, torch.device("cpu")), new_kf))
        counts, syncs = {}, []
        _sync(torch, dev)
        t1 = time.perf_counter()
        with count_syncs(torch, dev, syncs):
            m = pre0(m, new_kf, cfg_, n_nb, device, counts=counts)
        _sync(torch, dev)
        rows.append(dict(slot=new_kf, pre_ms=(time.perf_counter() - t1) * 1e3,
                         syncs_pre=syncs[0], **{k: int(v) for k, v in counts.items()}))
        return m

    def ba(m, new_kf, cfg_, device=None):
        trunc = tr.local_ba_truncation(m, cfg_, new_kf).tolist()
        n_local = int(tr._local_window_masks(m, cfg_, new_kf)[0].sum())
        syncs = []
        _sync(torch, dev)
        t1 = time.perf_counter()
        with count_syncs(torch, dev, syncs):
            m = ba0(m, new_kf, cfg_, device)
        _sync(torch, dev)
        rows[-1].update(ba_ms=(time.perf_counter() - t1) * 1e3, syncs_ba=syncs[0],
                        window_kfs=n_local, window_points=trunc[2], window_bird=trunc[3],
                        dropped=trunc[0], dropped_bird=trunc[1], n_mp=int(m.n_mp),
                        n_bp=int(m.n_bp), n_kf=int(m.kf_valid.sum()))
        return m

    tr.local_mapping_pre, tr.local_mapping_ba = pre, ba
    try:
        yield
    finally:
        tr.local_mapping_pre, tr.local_mapping_ba = pre0, ba0


@contextlib.contextmanager
def stage_timers(torch, dev, out: dict):
    """Wrap the facade's ``build_frame`` and ``track_frame_core`` with
    synchronised timers: ``out`` gets the ms of each (the last call)."""
    from fishbirdeyevisualslam_torch.slam import system, tracking

    def timed(name, fn):
        def run(*args, **kwargs):
            _sync(torch, dev)
            t1 = time.perf_counter()
            r = fn(*args, **kwargs)
            _sync(torch, dev)
            out[name] = (time.perf_counter() - t1) * 1e3
            return r
        return run

    build0, core0 = system.build_frame, tracking.track_frame_core
    system.build_frame = timed("build_frame", build0)
    tracking.track_frame_core = timed("track_frame_core", core0)
    try:
        yield
    finally:
        system.build_frame, tracking.track_frame_core = build0, core0


def phase_facade(torch, cfg, dev, n_frames: int = N_MAP, profile: bool = False,
                 survey: bool = False, snap: dict | None = None):
    """The port's entry point, ``SlamSystem(cfg, device=dev).track``, over an
    arc drive rendered by the port's copy of io/synthetic.py: two-view
    initialization at the doubled front budget, tracking, keyframe insertion
    and the synchronous local mapping step, at full width.  Prints the frame
    and route of the initialization, each frame's state, the keyframes, each
    keyframe's mapping times (synchronised timers around the two mapping
    stages), host syncs, window and point counts, the tracer's spans, the
    host syncs of a tracked frame through the facade and the ATE.  Then holds
    the init pair against the port's CPU facade with the same draws, the last
    keyframe's mapping step against the CPU and against itself on the card,
    and drives reset() with a re-initialization and localization mode on a
    second facade over the same drive.  Returns (the kernel launches over the drive, the ATE,
    the per-keyframe rows, the launches of the patch gather at the init
    budget).  With ``survey``, the mapping step of every fourth keyframe and
    of the last is held against the CPU instead (the readings behind that
    check's bound), and nothing after it runs.  ``snap`` receives a copy of
    the facade after N_KIDNAP frames and the drive (phase 6's kidnap), the
    facade after the drive and its session after N_RESUME frames (phases
    8 and 9)."""
    import copy
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem

    cap = cfg.capacity
    n_nb = cfg.tracking.mapping_neighbors
    seq = render_sequence(cfg, n_frames, "arc", MAP_STEP, seed=0, check=(0, n_frames - 1))
    print(f"[facade] an arc drive of {n_frames} frames, {MAP_STEP} m per frame (front "
          f"{cfg.camera.width}x{cfg.camera.height}, "
          f"bird {cfg.bird.cols}x{cfg.bird.rows}; K={cap.max_keyframes} P={cap.max_points} "
          f"PB={cap.max_bird_points} M={cap.max_obs_per_point}, {cap.max_front_kp}+"
          f"{cap.max_bird_kp} keypoints, {cfg.orb.n_features_init} front until initialized, "
          f"mapping_neighbors {n_nb}, local BA {cap.max_local_kfs}+{cap.max_local_observers} "
          f"keyframes, {cap.max_local_points}+{cap.max_local_bird_points} points)", flush=True)

    def track(sys_, i):
        fr = seq.frames[i]
        return sys_.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"])

    counters = kernel_counters()
    sys_ = SlamSystem(cfg, device=dev)
    rows, captured, frame_syncs = [], {}, []
    for c in counters:
        c.launches = 0
    t_drive = time.perf_counter()
    scalars = []   # per tracked frame: motion-model matches, inliers, bird inliers
    keep = set(range(4, n_frames, 4)) if survey else ()
    with mapping_timers(torch, cfg, dev, rows, captured, keep):
        for i in range(n_frames):
            syncs, sc0 = [], sys_.last_scalars
            try:
                with count_syncs(torch, dev, syncs):
                    track(sys_, i)
            except NotImplementedError as e:
                fail(f"frame {i}: {e}; states so far {[x.state for x in sys_.trajectory]}, "
                     f"(frame, motion-model matches, inliers, bird inliers) {scalars}")
            if sys_.last_scalars is not sc0:
                sc = sys_.last_scalars
                scalars.append((i, sc[0], sc[1], sc[4]))
            if sys_.trajectory[-1].state == tr.OK:
                frame_syncs.append((i, sys_.trajectory[-1].is_keyframe, syncs[0]))
            if snap is not None and i == N_KIDNAP - 1:
                snap.update(sys=copy.deepcopy(sys_), seq=seq)
            if snap is not None and i == N_RESUME - 1:
                resume = copy.deepcopy(sys_)
    _sync(torch, dev)
    dt = time.perf_counter() - t_drive
    launches = {c.__name__: c.launches for c in counters}
    if snap is not None:
        # phase 9's session, saved outside the timed drive
        from fishbirdeyevisualslam_torch.io.session import save_session
        buf = io.BytesIO()
        save_session(resume, buf)
        del resume
        snap.update(sync=sys_, session=buf.getvalue())
    states = [e.state for e in sys_.trajectory]
    stages = sys_.tracer.report()
    n_init_frames = stages.get("initialize", {}).get("count", 0)
    ini = sys_.inits[0] if sys_.inits else None
    if ini is None:
        fail("the facade never initialized")
    print(f"[facade] initialized on frame {ini['frame']} (reference frame {ini['ref_frame']}) by "
          f"the {ini['route']} route: {ini['matches']} init matches, {ini['triangulated']} points "
          f"triangulated, map {ini['n_mp']} points and {ini['n_bp']} bird points after the "
          f"initial BA; T21 = {np.round(ini['T21'], 5).tolist()}", flush=True)
    print(f"[facade] {n_frames} frames in {dt:.1f} s ({n_frames / dt:.2f} frames/s with mapping); "
          f"states per frame {states}; keyframes at frames "
          f"{sys_.keyframe_indices().tolist()}", flush=True)
    print(f"[facade] per tracked frame (frame, motion-model matches, inliers, bird inliers): "
          f"{scalars}", flush=True)
    for k, r in enumerate(rows, 1):
        print(f"[facade] keyframe {k} (slot {r['slot']}): local_mapping_pre {r['pre_ms']:.1f} ms, "
              f"local_mapping_ba {r['ba_ms']:.1f} ms (synchronised); host syncs "
              f"{r['syncs_pre']} + {r['syncs_ba']}; window {r['window_kfs']} keyframes, "
              f"{r['window_points']} + {r['window_bird']} points (dropped by the caps "
              f"{r['dropped']} + {r['dropped_bird']}); points created {r['created']}, merged "
              f"{r['merged']}, culled {r['culled']} (bird {r['bird_culled']}), evicted "
              f"{r['evicted']}; map {r['n_kf']} keyframes, {r['n_mp']} points, {r['n_bp']} bird "
              "points", flush=True)
    if rows:
        med = lambda k: statistics.median(r[k] for r in rows)
        print(f"[facade] per keyframe, median: local_mapping_pre {med('pre_ms'):.1f} ms, "
              f"local_mapping_ba {med('ba_ms'):.1f} ms, host syncs {med('syncs_pre')} + "
              f"{med('syncs_ba')}", flush=True)
    print("[facade] tracer spans (host, s): " + "; ".join(
        f"{k} count {v['count']} mean {v['mean_s'] * 1e3:.1f} ms max {v['max_s'] * 1e3:.1f} ms"
        for k, v in stages.items()), flush=True)
    print(f"[facade] host syncs per tracked frame outside its mapping step (frame, keyframe, "
          f"syncs): {frame_syncs}", flush=True)
    print(f"[facade] kernel launches over the drive: {json.dumps(launches)}; the patch gather "
          f"at the init budget ({cfg.orb.n_features_init} windows): {n_init_frames} of them",
          flush=True)
    Twb = sys_.frame_trajectory_Twb()
    ate = evaluate.ate_rmse_vs_gt(Twb, seq.gt[:n_frames])
    print(f"[facade] ATE {ate:.4f} m (RMSE over {len(Twb)} frames, SE2-aligned, io/evaluate.py) "
          f"over a {MAP_STEP * (n_frames - 1):.1f} m drive (bound {ATE_BOUND} m)", flush=True)

    n_ok = sum(s == tr.OK for s in states)
    if any(s == tr.LOST for s in states) or states[-1] != tr.OK \
            or n_ok != n_frames - ini["frame"]:
        fail(f"not every frame after the initialization was tracked: states {states}")
    if not rows or sum(r["created"] for r in rows) < 100:
        fail("too few keyframes or points were created over the drive")
    if not (math.isfinite(ate) and ate < ATE_BOUND):
        fail(f"ATE {ate} m is not below {ATE_BOUND} m")
    if dev.type == "cuda" and any(launches[c.__name__] == 0 for c in counters):
        fail(f"a kernel of the path was never launched: {launches}")

    # --- the init pair on the port's CPU facade, with the same draws
    cpu = SlamSystem(cfg, device="cpu")
    t1 = time.perf_counter()
    for i in range(ini["frame"] + 1):
        track(cpu, i)
    c_ini = cpu.inits[0] if cpu.inits else None
    if c_ini is None:
        fail("the CPU facade did not initialize on the same frames")
    dT = se3.log(se3.compose(torch.from_numpy(ini["T21"]),
                             se3.inverse(torch.from_numpy(c_ini["T21"])))).abs().max().item()
    near = lambda x, y: abs(x - y) <= max(5, 0.01 * y)
    print(f"[facade] the init pair on the CPU ({time.perf_counter() - t1:.1f} s): frame "
          f"{c_ini['frame']} by the {c_ini['route']} route, {c_ini['matches']} matches, "
          f"{c_ini['triangulated']} points, map {c_ini['n_mp']} + {c_ini['n_bp']}; T21 diff "
          f"{dT:.3g} (bounds: same frame and route, T21 <= 1e-3, counts within max(5, 1%))",
          flush=True)
    if not (c_ini["frame"] == ini["frame"] and c_ini["route"] == ini["route"] and dT <= 1e-3
            and all(near(ini[k], c_ini[k]) for k in ("triangulated", "n_mp", "n_bp"))):
        fail("the init pair on the card and on the CPU disagree")

    if survey:
        worst, kept = {}, captured.get("kept", [])
        if not kept or kept[-1][0] != len(rows):
            kept.append((len(rows), captured["m"], captured["slot"]))
        for k, m, slot in kept:
            d, spread, t_cpu = mapping_step_diffs(torch, cfg, dev, m, slot, n_nb, spread=True)
            for name, x in (("card vs CPU", d), ("one CPU thread vs many", spread)):
                print(f"[survey] keyframe {k} (slot {slot}), {name}: {describe_diff(x)}",
                      flush=True)
                for q in ("px99", "b99", "dT"):
                    worst[name, q] = max(worst.get((name, q), 0.0), x[q])
        print("[survey] largest over the keyframes: " + "; ".join(
            f"{name} {q} {v:.4g}" for (name, q), v in worst.items()), flush=True)
        return launches, ate, rows, n_init_frames

    # --- the last keyframe's mapping step: twice on the card, once on the CPU
    m0, slot = captured["m"], captured["slot"]
    if profile and dev.type == "cuda":
        profile_call(torch, "local_mapping_step",
                     lambda: tr.local_mapping_step(m0, slot, cfg, n_nb, device=dev))
        profile_initialize(torch, cfg, dev, seq, ini)
    if dev.type == "cuda":
        runs = [tr.local_mapping_step(m0, slot, cfg, n_nb, device=dev) for _ in range(2)]
        diff = [k for k, x, y in zip(m0._fields, *runs) if not torch.equal(x, y)]
        if diff:
            fail(f"two card runs of local_mapping_step differ in {diff}")
        print(f"[facade] local_mapping_step on keyframe {len(rows)} (slot {slot}), run twice on "
              "the card: bit-identical in every field", flush=True)
    d, _, t_cpu = mapping_step_diffs(torch, cfg, dev, m0, slot, n_nb)
    print(f"[facade] keyframe {len(rows)}'s step on the CPU ({t_cpu:.1f} s), card vs CPU: "
          f"{describe_diff(d)} (bounds: keyframes equal, pose diff <= 1e-3, counts within "
          f"max(5, 1%), >= 0.98 of the points and of the bird points at the same slot, p99 <= "
          f"{PX99_BOUND} px in the observing keyframes and <= 5e-3 m; the f32 spread of one "
          "CPU thread against many: --survey)", flush=True)
    c = d["counts"]
    if not (d["kf_same"] and d["dT"] <= 1e-3 and near(c[0], c[1]) and near(c[2], c[3])
            and near(c[4], c[5]) and d["share"] >= 0.98 and d["px99"] <= PX99_BOUND
            and d["bshare"] >= 0.98 and d["b99"] <= 5e-3):
        fail("local_mapping_step on the card and on the CPU disagree")

    # --- the modes, as tests/test_system_modes.py drives them, on a second
    # facade over the same drive: reset() and re-initialization, then
    # localization mode
    modes = SlamSystem(cfg, device=dev)
    for i in range(N_BEFORE_RESET):
        track(modes, i)
    modes.reset()
    if modes.map is not None or any(e.ref_kf != -2 for e in modes.trajectory):
        fail("reset() left a map or an unfrozen trajectory entry")
    n_reset = N_BEFORE_RESET + N_RESET
    for i in range(N_BEFORE_RESET, n_reset):
        track(modes, i)
    Twb = modes.frame_trajectory_Twb()
    ate_r = evaluate.ate_rmse_vs_gt(Twb, seq.gt[:n_reset])
    re = modes.inits[-1] if len(modes.inits) > 1 else None
    states = [e.state for e in modes.trajectory[N_BEFORE_RESET:]]
    print(f"[facade] modes: {N_BEFORE_RESET} frames, reset, {N_RESET} frames: re-initialized on "
          f"frame {None if re is None else re['frame']} ({None if re is None else re['route']} "
          f"route), states after the reset {states}, {len(Twb)} poses, all finite "
          f"{bool(np.isfinite(Twb).all())}, ATE over all {len(Twb)} frames {ate_r:.4f} m (one "
          "world frame: the new map is chained onto the dead-reckoned pose before the reset)",
          flush=True)
    if re is None or len(Twb) != n_reset or not np.isfinite(Twb).all() \
            or states[-1] != tr.OK or not ate_r < ATE_BOUND:
        fail("reset() and re-initialization misbehaved")
    n_kf, n_mp = int(modes.map.n_kf), int(modes.map.mp_valid.sum())
    modes.activate_localization_mode()
    # frames without a keyframe: host syncs on the first half, and on the
    # second the synchronised time of the whole call against that of its
    # build_frame and track_frame_core
    loc_syncs, loc_ms = [], []
    for k, i in enumerate(range(n_reset, n_reset + N_LOCAL)):
        if k < N_LOCAL // 2:
            with count_syncs(torch, dev, loc_syncs):
                track(modes, i)
            continue
        stage = {}
        with stage_timers(torch, dev, stage):
            _sync(torch, dev)
            t1 = time.perf_counter()
            track(modes, i)
            _sync(torch, dev)
        total = (time.perf_counter() - t1) * 1e3
        loc_ms.append((total, stage["build_frame"], stage["track_frame_core"]))
    print(f"[facade] modes: tracked frames without a keyframe: host syncs {loc_syncs} "
          "(track_frame_core alone makes 2); synchronised ms (whole call, build_frame, "
          f"track_frame_core, the facade's own) {[(round(t, 2), round(b, 2), round(c, 2), round(t - b - c, 2)) for t, b, c in loc_ms]}",
          flush=True)
    states = [e.state for e in modes.trajectory[n_reset:]]
    n_kf2, n_mp2 = int(modes.map.n_kf), int(modes.map.mp_valid.sum())
    modes.deactivate_localization_mode()
    print(f"[facade] modes: localization mode, {N_LOCAL} frames: states {states}, keyframes "
          f"{n_kf} -> {n_kf2}, points {n_mp} -> {n_mp2}", flush=True)
    if n_kf2 != n_kf or n_mp2 != n_mp or any(s != tr.OK for s in states) \
            or modes.localization_only:
        fail("localization mode changed the map or lost tracking")
    return launches, ate, rows, n_init_frames


# ---------------------------------------------------------------------------
# rendering in a process pool (the drives of phases 5-7)
# ---------------------------------------------------------------------------

RENDER_WORKERS = 8
_RENDER = {}


def _render_child() -> None:
    import torch
    torch.set_num_threads(1)


def _render_frame(i: int) -> dict:
    from fishbirdeyevisualslam_torch.io import synthetic
    return synthetic.render_frame(_RENDER["world"], _RENDER["cfg"], _RENDER["gt"][i], i)


def _render_real_frame(i: int) -> dict:
    from fishbirdeyevisualslam_torch.io import realism
    r = _RENDER
    return realism.render_real_frame(r["world"], r["cfg"], r["cfg_true"], r["gt"][i], i)


def _pool_map(fn, n: int, **shared) -> list:
    """``fn(i)`` for i < n in ``RENDER_WORKERS`` forked processes that see
    ``shared`` in ``_RENDER`` (they run numpy and CPU torch only, never the
    card)."""
    import multiprocessing as mp
    _RENDER.update(shared)
    workers = min(RENDER_WORKERS, os.cpu_count() or 1, n)
    with mp.get_context("fork").Pool(workers, _render_child) as pool:
        return pool.map(fn, range(n))


def pooled_render(cfg, n_frames: int):
    """A ``render(world, gt)`` for ``synthetic.make_sequence`` (and the
    demo's ``main``) that renders its frames in the pool."""
    def pooled(world, gt):
        try:
            return _pool_map(_render_frame, n_frames, cfg=cfg, gt=gt, world=world)
        finally:
            _RENDER.clear()
    return pooled


def render_sequence(cfg, n_frames: int, kind: str, step: float, odom_noise: float = 0.0,
                    seed: int = 0, check=(), degrade=None):
    """``io/synthetic.py:make_sequence``, its clean frames rendered by
    ``RENDER_WORKERS`` forked processes that share the world it built, then
    degraded by ``degrade`` where given; the frames in ``check`` (clean
    sequences only) are rendered again here by ``make_sequence``'s serial
    route (``synthetic.render_frame``) and must be equal."""
    from fishbirdeyevisualslam_torch.io import synthetic
    workers = min(RENDER_WORKERS, os.cpu_count() or 1, n_frames)

    def pooled(world, gt):
        return _pool_map(_render_frame, n_frames, cfg=cfg, gt=gt, world=world)

    t0 = time.perf_counter()
    try:
        seq = synthetic.make_sequence(cfg, n_frames, kind, odom_noise, seed, step,
                                      degrade=degrade, render=pooled)
        dt = time.perf_counter() - t0
        for i in check:
            ref = synthetic.render_frame(_RENDER["world"], cfg, seq.gt[i], i)
            if not all(np.array_equal(seq.frames[i][k], ref[k]) for k in ref):
                fail(f"frame {i} of the pooled {kind} render differs from its serial render")
    finally:
        _RENDER.clear()
    print(f"[render] {kind} drive of {n_frames} frames, {step} m per frame, odometry noise "
          f"{odom_noise}, seed {seed}{', degraded' if degrade is not None else ''}: {dt:.1f} s "
          f"in {workers} processes (the world built once); frames {list(check)} equal to their "
          f"serial render", flush=True)
    return seq


@contextlib.contextmanager
def sync_timers(torch, dev, module, names, out: list, keep_args: bool = False,
                summary=None):
    """Wrap ``module``'s functions ``names`` (looked up at each call) with
    synchronised timers: ``out`` gets (name, ms, with ``keep_args`` the
    call's first argument) per call; ``summary`` (name -> function of the
    result) appends what it gives to the entry.  The timers' own
    synchronisations, and the summaries' host reads, are hidden from an
    enclosing ``count_syncs``.  Calls from other threads go through untimed."""
    saved = {n: getattr(module, n) for n in names}
    me = threading.get_ident()

    def quiet_sync():
        with count_syncs(torch, dev, []):
            _sync(torch, dev)

    def timed(name, fn):
        def run(*args, **kwargs):
            if threading.get_ident() != me:
                return fn(*args, **kwargs)
            quiet_sync()
            t1 = time.perf_counter()
            r = fn(*args, **kwargs)
            quiet_sync()
            ms = (time.perf_counter() - t1) * 1e3
            with count_syncs(torch, dev, []):
                extra = (summary[name](r),) if summary and name in summary else ()
            out.append((name, ms, args[0] if keep_args and args else None) + extra)
            return r
        return run

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def loop_attempts(torch, dev, lc, out: list):
    """Record each loop candidate ``LoopCloser.process_keyframe`` tries into
    ``out``: the keyframe and the candidate (slot, insertion, frame id), the
    RANSAC's inliers and success, the projected matches, the odometry vet's
    (disagreement, tolerance) m, and ``closed`` (set by the caller).  The
    records' own host reads are hidden from an enclosing ``count_syncs``.
    Calls from other threads go through unrecorded."""
    transform0, verify0, vet0 = (lc.compute_loop_transform, lc.verify_loop_projection,
                                 lc.LoopCloser._odom_vet)
    me = threading.get_ident()

    def transform(m, cur, cand, cfg_, gumbel):
        if threading.get_ident() != me:
            return transform0(m, cur, cand, cfg_, gumbel)
        S, n_in, ok = transform0(m, cur, cand, cfg_, gumbel)
        with count_syncs(torch, dev, []):
            seq, frame, cand_frame, n_in_h, ok_h = torch.stack(
                [m.kf_seq[cur], m.kf_frame_id[cur], m.kf_frame_id[cand], n_in.to(torch.int32),
                 ok.to(torch.int32)]).tolist()
        out.append(dict(kf=cur, seq=seq, frame=frame, cand=cand, cand_frame=cand_frame,
                        n_inliers=n_in_h, ok=bool(ok_h), n_proj=None, vet=None, closed=False))
        return S, n_in, ok

    def verify(m, cur, cand, T, cfg_):
        if threading.get_ident() != me:
            return verify0(m, cur, cand, T, cfg_)
        n = verify0(m, cur, cand, T, cfg_)
        with count_syncs(torch, dev, []):
            out[-1]["n_proj"] = int(n)
        return n

    def vet(self, m, cur, cand, T):
        if threading.get_ident() != me:
            return vet0(self, m, cur, cand, T)
        out[-1]["vet"] = vet0(self, m, cur, cand, T)
        return out[-1]["vet"]

    lc.compute_loop_transform, lc.verify_loop_projection = transform, verify
    lc.LoopCloser._odom_vet = vet
    try:
        yield
    finally:
        lc.compute_loop_transform, lc.verify_loop_projection = transform0, verify0
        lc.LoopCloser._odom_vet = vet0


def kernel_counters():
    from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    return (cuda_fast.fast_detect_levels, cuda_patch.extract_patches,
            cuda_matcher.fused_projection_match_dual, cuda_matcher.fused_projection_match,
            cuda_pose_opt.pose_optimization)


def _finite_poses(sys_) -> bool:
    return bool(np.isfinite(sys_.frame_trajectory_Twb()).all())


# ---------------------------------------------------------------------------
# phase 6: recovery (the fallback, LOST, relocalization, re-initialization)
# ---------------------------------------------------------------------------

N_ARC = 42           # frames of the recovery drive: the arc whose tracking is lost on frame 12
N_KIDNAP = 14        # frames of phase 5's drive behind the kidnapped facade (tests/test_reloc.py)
KIDNAP_REVISIT = 6
KIDNAP_DRIFT = (0.0, 0.0, 0.3, 18.0, 9.0, 0.0)   # se3 of the corrupted belief
MAX_LOST_SPELL = 3   # frames: the JAX facade relocalized on the first LOST frame of this arc


def phase_recovery(torch, cfg, dev, snap=None, profile: bool = False):
    """The facade over the 42-frame arc (``make_sequence(cfg, 42, "arc",
    step=0.5, seed=0)``): each frame's state, route and inliers, the
    synchronised stage times of the relocalizations and the kernels 4 and 5
    launched on the LOST frames; then a facade over phase 5's first 14
    frames (``snap``, or driven here) kidnapped as ``tests/test_reloc.py``
    does and relocalized on the revisited frame 6, and that relocalization's
    ``relocalize_against`` profiled.  Returns the kernel launches of the
    arc's drive."""
    from fishbirdeyevisualslam_torch.geometry import ipm, se3
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    from fishbirdeyevisualslam_torch.ops import cuda_matcher
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt

    seq = render_sequence(cfg, N_ARC, "arc", MAP_STEP, seed=0, check=(0, N_ARC // 2, N_ARC - 1))
    track = lambda s, i, odom=None: s.track(seq.frames[i]["front"], seq.frames[i]["bird"],
                                            seq.frames[i]["mask"],
                                            seq.odom[i] if odom is None else odom,
                                            seq.frames[i]["timestamp"])
    counters = kernel_counters()
    k45 = (cuda_matcher.fused_projection_match, cuda_pose_opt.pose_optimization)
    sys_ = SlamSystem(cfg, device=dev)
    names = {tr.NOT_INITIALIZED: "uninit", tr.OK: "OK", tr.LOST: "LOST"}
    stages, rows, lost_k45 = [], [], [0, 0]
    reloc = ("relocalize_group_candidates", "relocalize_against")
    pnp_summary = {"relocalize_against": lambda r: (int(r[2]), bool(r[3]))}
    for c in counters:
        c.launches = 0
    t_drive = time.perf_counter()
    with sync_timers(torch, dev, lc, reloc, stages, summary=pnp_summary):
        for i in range(N_ARC):
            was_lost = sys_.state == tr.LOST
            n0 = [c.launches for c in k45]
            n_st, syncs, sites = len(stages), [], collections.Counter()
            _sync(torch, dev)
            t1 = time.perf_counter()
            try:
                with count_syncs(torch, dev, syncs, sites):
                    track(sys_, i)
            except NotImplementedError as e:
                fail(f"frame {i} raised: {e}")
            _sync(torch, dev)
            ms = (time.perf_counter() - t1) * 1e3
            if was_lost:
                for j, c in enumerate(k45):
                    lost_k45[j] += c.launches - n0[j]
            rows.append(dict(frame=i, state=names[sys_.trajectory[-1].state],
                             route=sys_.last_route, inliers=sys_.last_inliers, ms=ms,
                             syncs=syncs[0], sites=sites, was_lost=was_lost,
                             reloc=[(n, round(t, 2)) + tuple(x[3:]) for x in stages[n_st:]
                                    for n, t in [x[:2]]]))
    _sync(torch, dev)
    dt = time.perf_counter() - t_drive
    launches = {c.__name__: c.launches for c in counters}
    print(f"[recovery] {N_ARC} frames in {dt:.1f} s; per frame (frame, state, route, inliers, "
          "synchronised ms): " + "; ".join(
              f"{r['frame']} {r['state']} {r['route']} {r['inliers']} {r['ms']:.0f}"
              for r in rows), flush=True)
    for r in rows:
        if r["reloc"]:
            print(f"[recovery] frame {r['frame']} ({r['route']}): relocalization stages "
                  f"(synchronised ms; relocalize_against's PnP inliers and success) "
                  f"{r['reloc']}", flush=True)
    print("[recovery] host syncs per frame (frame, syncs): of the frames that were LOST on "
          f"entry {[(r['frame'], r['syncs']) for r in rows if r['was_lost']]}; of the tracked "
          f"frames {[(r['frame'], r['syncs']) for r in rows if not r['was_lost']]}", flush=True)
    lost_rows = [r for r in rows if r["was_lost"]]
    print(f"[recovery] host syncs of the {len(lost_rows)} frames that were LOST on entry, by "
          "call site (syncs, site: the port's innermost frames): "
          f"{sum((r['sites'] for r in lost_rows), collections.Counter()).most_common()}",
          flush=True)
    lost = [r["frame"] for r in rows if r["state"] == "LOST"]
    spells, start = [], None
    for r in rows:
        if r["state"] == "LOST" and start is None:
            start = r["frame"]
        elif r["state"] != "LOST" and start is not None:
            spells.append((start, r["frame"] - start, r["route"]))
            start = None
    if start is not None:
        spells.append((start, N_ARC - start, None))
    Twb = sys_.frame_trajectory_Twb()
    ate = evaluate.ate_rmse_vs_gt(Twb, seq.gt)
    print(f"[recovery] LOST frames {lost}; spells (first frame, length, the route that ended "
          f"it) {spells}; fallback frames {[r['frame'] for r in rows if r['route'] == 'fallback']}"
          f"; keyframes {len(sys_.keyframe_indices())}; forced evictions "
          f"{sys_.n_forced_kf_evictions}; loops closed {sys_.n_loops_closed}; ATE {ate:.4f} m; "
          f"kernel launches over the drive {json.dumps(launches)}, on the LOST frames: "
          f"fused_projection_match {lost_k45[0]}, pose_optimization {lost_k45[1]}", flush=True)
    if not _finite_poses(sys_):
        fail("a pose of the recovery drive is not finite")
    if spells and (spells[0][1] > MAX_LOST_SPELL or spells[0][2] is None):
        fail(f"the first LOST spell lasted {spells[0][1]} frames (bound {MAX_LOST_SPELL})")
    if lost and dev.type == "cuda" and 0 in lost_k45:
        fail(f"kernels 4 and 5 were not both launched on the LOST frames: {lost_k45}")
    if dev.type == "cuda" and any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")

    # --- the kidnapped facade (tests/test_reloc.py)
    if snap is None:
        seq5 = render_sequence(cfg, N_MAP, "arc", MAP_STEP, seed=0)
        k = SlamSystem(cfg, device=dev)
        for i in range(N_KIDNAP):
            k.track(seq5.frames[i]["front"], seq5.frames[i]["bird"], seq5.frames[i]["mask"],
                    seq5.odom[i], seq5.frames[i]["timestamp"])
    else:
        k, seq5 = snap["sys"], snap["seq"]
    if k.state != tr.OK:
        fail("the facade to kidnap is not tracking")
    before = k.frame_trajectory_Twb()[KIDNAP_REVISIT]
    drift = se3.exp(torch.tensor(KIDNAP_DRIFT, device=dev))
    k.state, k.n_lost_frames, k._reloc_frame_id = tr.LOST, 1, -10000
    k.last_Tcw = se3.compose(k.last_Tcw, drift)
    fr = seq5.frames[KIDNAP_REVISIT]
    stages = []
    n0 = [c.launches for c in k45]
    k_syncs, k_sites = [], collections.Counter()
    with sync_timers(torch, dev, lc, reloc, stages, summary=pnp_summary):
        _sync(torch, dev)
        t1 = time.perf_counter()
        with count_syncs(torch, dev, k_syncs, k_sites):
            Tcw = k.track(fr["front"], fr["bird"], fr["mask"], seq5.odom[N_KIDNAP - 1],
                          fr["timestamp"])
        _sync(torch, dev)
    ms = (time.perf_counter() - t1) * 1e3
    Twb = ipm.Twb_from_Twc(cfg.extrinsics, se3.inverse(torch.from_numpy(Tcw))).numpy()
    err = float(np.linalg.norm(Twb[4:6] - before[4:6]))
    print(f"[recovery] kidnapped after {N_KIDNAP} frames of phase 5's drive (belief off by "
          f"{KIDNAP_DRIFT}), frame {KIDNAP_REVISIT} revisited: state "
          f"{names[k.state]}, route {k.last_route}, {k.last_inliers} inliers, {ms:.1f} ms "
          f"synchronised, {k_syncs[0]} host syncs (stages {[(x[0], round(x[1], 2)) + tuple(x[3:]) for x in stages]}; "
          f"kernels 4 and 5 "
          f"launched {[c.launches - x for c, x in zip(k45, n0)]}); {err:.4f} m from its own "
          "estimate before the kidnap (bound 1.0 m)", flush=True)
    print(f"[recovery] the kidnapped frame's host syncs by call site: {k_sites.most_common()}",
          flush=True)
    if k.state != tr.OK or k.last_route != "relocalized" or not err < 1.0:
        fail("the kidnapped facade did not relocalize")
    if dev.type == "cuda":
        from fishbirdeyevisualslam_torch.ops import vocab
        from fishbirdeyevisualslam_torch.slam.frame import build_frame
        from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws
        f = build_frame(fr["front"], fr["bird"], fr["mask"], seq5.odom[N_KIDNAP - 1],
                        fr["timestamp"], cfg, cfg.capacity.max_front_kp, None,
                        cfg.capacity.max_bird_kp, device=dev)
        words = vocab.word_ids(f.desc_pm1)
        cand = int(lc.relocalize_group_candidates(k.map, words, cfg, f.kp_valid)[0][0])
        g = GumbelDraws(0)(1, lc.RANSAC_ITERS, f.uv.shape[0])[0].to(dev)
        profile_call(torch, f"relocalize_against (candidate slot {cand}; ransac_pnp over "
                            f"{lc.RANSAC_ITERS} hypotheses)",
                     lambda: lc.relocalize_against(k.map, f.desc_pm1, words, cfg, f.uv,
                                                   f.kp_valid, cand, g), tables=profile)
    return launches


# ---------------------------------------------------------------------------
# phase 7: loop closing
# ---------------------------------------------------------------------------

N_RECT = 160         # tests/test_loop_closing.py:141: the rectangle loop
RECT_STEP = 0.35
RECT_ODOM_NOISE = 0.02
RECT_ATE_BOUND = 0.5   # m: that test's bound
LOOP_FNS = ("detect_loop_groups", "compute_loop_transform", "verify_loop_projection",
            "seed_loop_correction", "search_and_fuse", "loop_essential_graph", "global_ba")
# the JAX package's facade over the same render (scripts/jax_arc_drive.py --kind rect
# --frames 160 --run 160 --step 0.35 --odom-noise 0.02 --loop, on the CPU): no loop
# closed, every candidate turned down, 21 of them by the odometry vet
JAX_RECT = "0 loops closed, ATE 0.1929 m, LOST on 51 57 66 76 89 98 115 139 147 155"


def phase_loop(torch, cfg, dev, profile: bool = False, keep: dict | None = None):
    """The facade over the 160-frame rectangle of ``tests/test_loop_closing.py``
    (odometry noise 0.02, seed 0), loop closing on: each frame's route and
    inliers, every loop candidate tried (its RANSAC inliers, projected
    matches and odometry vet), the closures with their stage times, the
    loops closed and the ATE (bound 0.5 m).  The JAX package closes no loop
    there (``JAX_RECT``), so the correction is exercised on the drive's first
    closure or, failing one, on its first candidate that passed the RANSAC
    and the projection gate, closed from its inputs with the odometry vet
    off: twice on the card (bit-identical, every stage timed), once on the
    CPU with the same draws (the same candidate, keyframe poses within 1e-3,
    front points p99 <= PX99_BOUND px in their observing keyframes); its
    global BA and essential graph profiled.  Returns the kernel launches of
    the drive; ``keep`` receives the correction's inputs (phase 9)."""
    import copy
    from fishbirdeyevisualslam_torch.device import to_device
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt

    seq = render_sequence(cfg, N_RECT, "rect", RECT_STEP, RECT_ODOM_NOISE, seed=0,
                          check=(0, N_RECT // 2, N_RECT - 1))
    counters = kernel_counters()
    sys_ = SlamSystem(cfg, device=dev)
    stages, closures, first, routes, keyframe_syncs = [], [], {}, [], []
    attempts, loop_sites = [], collections.Counter()
    gate = cfg.tracking.loop_min_proj_matches
    process0 = lc.LoopCloser.process_keyframe

    def process(closer, m, cur_kf):
        saved = copy.deepcopy(closer.__dict__ | {"tracer": None})
        n_st, n_att = len(stages), len(attempts)
        n5 = cuda_pose_opt.pose_optimization.launches
        syncs = []
        _sync(torch, dev)
        t1 = time.perf_counter()
        with count_syncs(torch, dev, syncs, loop_sites):
            out = process0(closer, m, cur_kf)
        _sync(torch, dev)
        keyframe_syncs.append((len(attempts) - n_att, syncs[0]))
        if out[1]:
            attempts[-1]["closed"] = True
            closures.append(dict(frame=sys_.frame_id, attempt=attempts[-1],
                                 ms=(time.perf_counter() - t1) * 1e3,
                                 stages=[(x[0], round(x[1], 1)) for x in stages[n_st:]],
                                 pose_kernel=cuda_pose_opt.pose_optimization.launches - n5))
        passed = [a for a in attempts[n_att:] if a["n_proj"] is not None
                  and a["n_proj"] >= gate]
        if passed and not first:
            first.update(m=m, cur=cur_kf, closer=saved, frame=sys_.frame_id, attempt=passed[0],
                         closed=out[1])
        return out

    for c in counters:
        c.launches = 0
    t_drive = time.perf_counter()
    lc.LoopCloser.process_keyframe = process
    try:
        with loop_attempts(torch, dev, lc, attempts), \
                sync_timers(torch, dev, lc, LOOP_FNS, stages):
            for i in range(N_RECT):
                fr = seq.frames[i]
                try:
                    sys_.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"])
                except NotImplementedError as e:
                    fail(f"frame {i} raised: {e}")
                routes.append((i, sys_.last_route, sys_.last_inliers))
    finally:
        lc.LoopCloser.process_keyframe = process0
    _sync(torch, dev)
    dt = time.perf_counter() - t_drive
    launches = {c.__name__: c.launches for c in counters}
    states = [e.state for e in sys_.trajectory]
    Twb = sys_.frame_trajectory_Twb()
    ate = evaluate.ate_rmse_vs_gt(Twb, seq.gt)
    detect = [x[1] for x in stages if x[0] == "detect_loop_groups"]
    vet = lambda a: a["vet"] and tuple(round(v, 2) for v in a["vet"])
    tried = [(a["frame"], a["cand_frame"], a["n_inliers"], a["n_proj"], vet(a)) for a in attempts]
    print(f"[loop] {N_RECT} frames in {dt:.1f} s; LOST frames "
          f"{[i for i, s in enumerate(states) if s == tr.LOST]}; keyframes "
          f"{len(sys_.keyframe_indices())}; loop detections {len(detect)} (median "
          f"{statistics.median(detect) if detect else 0:.1f} ms synchronised); candidates tried "
          "(frame, candidate's frame, RANSAC inliers, projected matches, odometry vet: "
          "disagreement / tolerance m) "
          f"{tried}; "
          f"loops closed {sys_.n_loops_closed}; ATE {ate:.4f} m over {len(Twb)} frames (bound "
          f"{RECT_ATE_BOUND} m); the JAX package on this render: {JAX_RECT}; kernel launches "
          f"{json.dumps(launches)}", flush=True)
    print("[loop] host syncs of loop closing per keyframe (candidates tried, syncs): "
          f"{keyframe_syncs}; by call site over the drive (syncs, site): "
          f"{loop_sites.most_common()}", flush=True)
    print("[loop] per frame (frame, route, inliers): " + "; ".join(
        f"{i} {r} {n}" for i, r, n in routes), flush=True)
    for c in closures:
        a = c["attempt"]
        print(f"[loop] closure on frame {c['frame']}: keyframe slot {a['kf']} (insertion "
              f"{a['seq']}) with candidate slot {a['cand']} (frame {a['cand_frame']}): "
              f"{a['n_inliers']} RANSAC inliers, {a['n_proj']} projected matches, odometry vet "
              f"{vet(a)}; {c['ms']:.1f} ms synchronised, stages {c['stages']}; pose kernel "
              f"launches {c['pose_kernel']}", flush=True)
    if not _finite_poses(sys_):
        fail("a pose of the loop drive is not finite")
    if dev.type == "cuda" and any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    if not ate < RECT_ATE_BOUND:
        fail(f"the rectangle's ATE is {ate} m (bound {RECT_ATE_BOUND} m)")
    if not first:
        fail("no loop candidate passed the RANSAC and the projection gate")
    if keep is not None:
        keep.update(first)

    # --- the correction at full width, from the captured inputs
    rcfg = cfg if first["closed"] else cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, loop_odom_vet=False))

    def replay(d, timed=None):
        closer = lc.LoopCloser(rcfg)
        closer.__dict__.update(copy.deepcopy(first["closer"]) | {"cfg": rcfg})
        n5 = cuda_pose_opt.pose_optimization.launches
        tried = []
        with loop_attempts(torch, d, lc, tried), \
                (sync_timers(torch, d, lc, LOOP_FNS, timed, keep_args=True)
                 if timed is not None else contextlib.nullcontext()):
            m, closed = closer.process_keyframe(to_device(first["m"], d), first["cur"])
        return m, closed, tried[-1], cuda_pose_opt.pose_optimization.launches - n5

    timed = []
    runs = [replay(dev, timed), replay(dev)]
    diff = [k for k, x, y in zip(runs[0][0]._fields, runs[0][0], runs[1][0])
            if not torch.equal(x, y)]
    t1, cpu_timed = time.perf_counter(), []
    cpu = replay(torch.device("cpu"), cpu_timed)
    t_cpu = time.perf_counter() - t1
    d = map_diff(torch, cfg, runs[0][0], cpu[0], first["cur"])
    a = runs[0][2]
    print(f"[loop] the correction at full width: the drive's first "
          f"{'closure' if first['closed'] else 'candidate past the RANSAC and the projection gate (turned down by the odometry vet), closed with the vet off'}"
          f", on frame {first['frame']}: keyframe frame {a['frame']} with candidate frame "
          f"{a['cand_frame']}, {a['n_inliers']} RANSAC inliers, {a['n_proj']} projected matches; "
          f"on the card: stages (synchronised ms) {[(x[0], round(x[1], 1)) for x in timed]}, "
          f"pose kernel launches {runs[0][3]}; twice on the card, fields that differ {diff}; on "
          f"the CPU ({t_cpu:.1f} s; stages, ms: {[(x[0], round(x[1])) for x in cpu_timed]}): "
          f"closed {cpu[1]}, candidate frame {cpu[2]['cand_frame']}, "
          f"{describe_diff(d)} (bounds: bit-identical, the same candidate, poses within 1e-3, "
          f"front points p99 <= {PX99_BOUND} px)", flush=True)
    if diff or not (runs[0][1] and cpu[1] and cpu[2]["cand"] == a["cand"]):
        fail("the loop correction is not reproduced")
    if not (d["dT"] <= 1e-3 and d["px99"] <= PX99_BOUND):
        fail("the loop correction on the card and on the CPU disagree")
    if dev.type == "cuda":
        if runs[0][3] < 1:
            fail("the loop correction launched no pose kernel")
        inputs = {x[0]: x[2] for x in timed}
        poses_meas = inputs["seed_loop_correction"].kf_Tcw
        for name, run in (("global_ba", lambda: lc.global_ba(inputs["global_ba"], rcfg)),
                          ("loop_essential_graph", lambda: lc.loop_essential_graph(
                              inputs["loop_essential_graph"], first["cur"], a["cand"],
                              poses_meas, rcfg))):
            profile_call(torch, f"{name} of that correction", run, tables=profile)
    return launches


# ---------------------------------------------------------------------------
# phase 8: asynchronous mapping
# ---------------------------------------------------------------------------

ASYNC_ATE_BOUND = 0.3   # m: tests/test_async_mapping.py:34
ASYNC_MIN_TRACKED = 0.6   # share of frames tracked: tests/test_async_mapping.py:30
N_PAIRS = 3             # synchronous / asynchronous drives timed, alternated
# frames of each timed drive: the first 10 of phase 5's render (the whole
# script held 573-760 s with 20, on hosts of different speed)
N_TIMED = 10


def _drive(sys_, seq, frames, flush: bool = False, each=None):
    for i in frames:
        fr = seq.frames[i]
        if each is not None:
            each(i, True)
        sys_.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"])
        if each is not None:
            each(i, False)
        if flush:
            sys_._pipeline.flush()
    sys_.finish()


def _same_run(torch, a, b) -> list:
    """What differs between two facades' runs: map fields, trajectory entries."""
    diff = [k for k, x, y in zip(a.map._fields, a.map, b.map) if not torch.equal(x, y)]
    if len(a.trajectory) != len(b.trajectory) or any(
            x.state != y.state or not np.array_equal(x.T_rel, y.T_rel)
            for x, y in zip(a.trajectory, b.trajectory)):
        diff.append("trajectory")
    return diff


@contextlib.contextmanager
def syncs_by_thread(torch, counts: collections.Counter):
    """Count the host syncs that ``torch.cuda.set_sync_debug_mode`` warns of
    (a lower bound), by thread name: the mode is process-wide, so the
    tracking thread's and the mapping worker's are told apart here."""
    def seen(message, *_args, **_kwargs):
        if "synchroniz" in str(message):
            counts[threading.current_thread().name] += 1

    if not torch.cuda.is_available():   # a CPU rehearsal: nothing to count
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def launches_by_stream(torch, dev, mapping_stream, counts: dict):
    """Count each kernel wrapper's calls by the stream they launch on (the
    mapping stream or tracking's), through the modules' attributes that
    every call site goes through.  A wrapper adds to its count through its
    module's name, which is the stand-in meanwhile: the stand-in's count is
    added to the wrapper's on the way out."""
    from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    mods = ((cuda_fast, "fast_detect_levels"), (cuda_patch, "extract_patches"),
            (cuda_matcher, "fused_projection_match_dual"),
            (cuda_matcher, "fused_projection_match"), (cuda_pose_opt, "pose_optimization"))
    saved = [(m, n, getattr(m, n)) for m, n in mods]

    def counted(name, fn):
        def run(*args, **kwargs):
            side = "mapping" if mapping_stream is not None and \
                torch.cuda.current_stream(dev) == mapping_stream else "tracking"
            counts[side][name] += 1
            return fn(*args, **kwargs)
        run.launches = 0
        return run

    stand_ins = [counted(n, fn) for _, n, fn in saved]
    for (m, n, _), run in zip(saved, stand_ins):
        setattr(m, n, run)
    try:
        yield
    finally:
        for (m, n, fn), run in zip(saved, stand_ins):
            setattr(m, n, fn)
            fn.launches += run.launches


def sync_drive(torch, cfg, dev) -> dict:
    """Phase 5's drive without its checks (``--async-only``): what phases 8
    and 9 take from phase 5, the render, the synchronous facade after it and
    its session after ``N_RESUME`` frames."""
    from fishbirdeyevisualslam_torch.io.session import save_session
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    seq = render_sequence(cfg, N_MAP, "arc", MAP_STEP, seed=0)
    sync = SlamSystem(cfg, device=dev)
    _drive(sync, seq, range(N_RESUME))
    buf = io.BytesIO()
    save_session(sync, buf)
    _drive(sync, seq, range(N_RESUME, N_MAP))
    return dict(seq=seq, sync=sync, session=buf.getvalue())


def phase_async(torch, cfg, dev, snap):
    """Asynchronous mapping over phase 5's 30-frame render: (a) the pipeline
    flushed after every frame must equal phase 5's synchronous facade bit for
    bit (map and trajectory); (b) a free-running drive: each frame's state,
    jobs submitted, merged and aborted, journaled keyframes, bird points
    replayed and dropped, frames tracked while a job was in flight, host syncs
    and kernel launches of each thread's stream, the tracking thread's
    per-frame wall with and without a job in flight, and the ATE (bound
    0.3 m, and at least 60% of the frames tracked: tests/test_async_mapping.py)
    beside the synchronous one; (c)
    synchronous and asynchronous frames/s over the render's first ``N_TIMED``
    frames, alternated ``N_PAIRS`` times.
    Returns the free drive's kernel launches."""
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem

    seq, sync = snap["seq"], snap["sync"]
    sync_ate = evaluate.ate_rmse_vs_gt(sync.frame_trajectory_Twb(), seq.gt[:N_MAP])

    # (a) scheduled: flushed after every frame
    a = SlamSystem(cfg, device=dev, async_mapping=True)
    t1 = time.perf_counter()
    try:
        _drive(a, seq, range(N_MAP), flush=True)
    finally:
        a.close()
    diff = _same_run(torch, a, sync)
    print(f"[async] scheduled (flushed after every frame): {N_MAP} frames in "
          f"{time.perf_counter() - t1:.1f} s, {a.n_jobs_submitted} jobs, {a.n_jobs_merged} "
          f"merged; against phase 5's synchronous drive, fields that differ {diff} "
          "(bound: bit-identical map and trajectory)", flush=True)
    if diff or a.n_jobs_submitted == 0 or a.n_jobs_merged != a.n_jobs_submitted:
        fail("the scheduled asynchronous drive differs from the synchronous one")

    # (b) free-running
    counters = kernel_counters()
    b = SlamSystem(cfg, device=dev, async_mapping=True)
    per_frame, job_ms, syncs = [], [], collections.Counter()
    by_stream = {"tracking": collections.Counter(), "mapping": collections.Counter()}
    stage0 = b._mapping_stage

    def timed_stage(st, item):
        threading.current_thread().name = "mapping worker"
        t = time.perf_counter()
        stage0(st, item)
        job_ms.append((time.perf_counter() - t) * 1e3)

    b._pipeline.close()
    b._pipeline = type(b._pipeline)([timed_stage], capacity=2)
    end_of_frame = torch.cuda.current_stream(dev).synchronize if dev.type == "cuda" \
        else (lambda: None)
    clock = {}

    def each(i, before):
        # a frame "with a job in flight" found the worker busy after its merge
        if before:
            clock.update(t=time.perf_counter(), n=b.n_frames_in_flight, s=syncs["MainThread"])
            return
        end_of_frame()
        per_frame.append((i, b.trajectory[-1].state, b.n_frames_in_flight > clock["n"],
                          b.trajectory[-1].is_keyframe, (time.perf_counter() - clock["t"]) * 1e3,
                          syncs["MainThread"] - clock["s"]))

    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    try:
        with syncs_by_thread(torch, syncs), \
                launches_by_stream(torch, dev, b._mapping_stream, by_stream):
            _drive(b, seq, range(N_MAP), each=each)
    finally:
        b.close()
    _sync(torch, dev)
    dt = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    states = [e.state for e in b.trajectory]
    ate = evaluate.ate_rmse_vs_gt(b.frame_trajectory_Twb(), seq.gt[:N_MAP])
    busy = [r[4] for r in per_frame if r[2]]
    idle = [r[4] for r in per_frame if not r[2]]
    med = lambda xs: statistics.median(xs) if xs else float("nan")
    print(f"[async] free-running: {N_MAP} frames in {dt:.1f} s; states per frame {states}; jobs "
          f"submitted {b.n_jobs_submitted}, merged {b.n_jobs_merged}, aborted (InterruptBA) "
          f"{b.n_jobs_aborted}; keyframes journaled {b.n_journal_kfs} (dropped "
          f"{b.n_journal_kfs_dropped}); bird points replayed {b.n_birds_replayed}, dropped "
          f"{b.n_bird_replay_dropped}; frames tracked while a job was in flight "
          f"{b.n_frames_in_flight}; loops closed {b.n_loops_closed}; keyframes at frames "
          f"{b.keyframe_indices().tolist()}; native pipeline {b._pipeline.is_native}", flush=True)
    print(f"[async] ATE {ate:.4f} m (bound {ASYNC_ATE_BOUND} m); the synchronous drive's "
          f"{sync_ate:.4f} m", flush=True)
    print(f"[async] tracking thread per frame (frame, state, job in flight, keyframe, ms to its "
          f"stream's end, host syncs): {[(i, s, bool(f), bool(k), round(t, 1), n) for i, s, f, k, t, n in per_frame]}",
          flush=True)
    print(f"[async] tracking thread's frame wall, median: {med(busy):.1f} ms with a job in "
          f"flight ({len(busy)} frames), {med(idle):.1f} ms without ({len(idle)} frames); the "
          f"worker's jobs {[round(x, 1) for x in job_ms]} ms (median {med(job_ms):.1f}); host "
          f"syncs by thread {dict(syncs)}; kernel launches by stream "
          f"{ {k: dict(v) for k, v in by_stream.items()} }", flush=True)
    # tests/test_async_mapping.py: tracking may drop while a job is in
    # flight (no keyframe is inserted meanwhile); at least 6 frames of 10 tracked
    n_ok = sum(s == tr.OK for s in states)
    print(f"[async] frames tracked {n_ok} of {N_MAP} (bound: at least 60%, "
          "tests/test_async_mapping.py)", flush=True)
    if n_ok < ASYNC_MIN_TRACKED * N_MAP:
        fail(f"the free-running asynchronous drive tracked too few frames: {states}")
    if not (b.n_jobs_submitted > 0 and b.n_jobs_merged == b.n_jobs_submitted):
        fail("the free-running drive merged no job, or not every job")
    if not (math.isfinite(ate) and ate < ASYNC_ATE_BOUND):
        fail(f"the asynchronous ATE {ate} m is not below {ASYNC_ATE_BOUND} m")
    if dev.type == "cuda" and any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    if not by_stream["mapping"]:
        print("[async] no kernel launched on the mapping stream (no loop transform ran)",
              flush=True)

    # (c) frames/s, synchronous and asynchronous alternated
    fps = {"sync": [], "async": []}
    for _ in range(N_PAIRS):
        for mode in ("sync", "async"):
            s = SlamSystem(cfg, device=dev, async_mapping=mode == "async")
            _sync(torch, dev)
            t1 = time.perf_counter()
            try:
                _drive(s, seq, range(N_TIMED))
                _sync(torch, dev)
            finally:
                s.close()
            fps[mode].append(N_TIMED / (time.perf_counter() - t1))
    print(f"[async] frames/s over the render's first {N_TIMED} frames, alternated sync / async "
          f"{N_PAIRS} times: sync {[round(x, 3) for x in fps['sync']]} (median "
          f"{statistics.median(fps['sync']):.3f}), async {[round(x, 3) for x in fps['async']]} "
          f"(median {statistics.median(fps['async']):.3f})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: session save and resume, the Sim3 loop correction, the dataset
# ---------------------------------------------------------------------------

RESUME_BOUND = 1e-4    # tests/test_session_resume.py:57
SIM3_ATE_BOUND = 0.3   # m: tests/test_e2e_flags.py:53


def phase_session_sim3(torch, cfg, dev, snap, first=None):
    """Phase 7's correction from its inputs with the odometry vet off, under
    ``fix_scale = False`` (the Sim3 ``correct_loop``, fusion and global BA):
    twice on the card (bit-identical), with the synchronised ms of
    ``correct_loop``, the Sim3 LM, ``search_and_fuse`` and ``global_ba``; then
    once on the CPU (the same candidate, poses within 1e-3, front points p99
    <= PX99_BOUND px), in a thread of its own while the card drives the rest
    of the phase, whose times are not read.  Phase 5's facade saved after
    ``N_RESUME`` frames (``io/session.py``), loaded in a new facade that
    finishes the drive: its trajectory against the uninterrupted one
    (bit-identical expected, bound 1e-4).  The arc with ``fix_scale =
    False``: every frame after the initialization tracked, ATE under 0.3 m.
    Returns the kernel launches of the two drives."""
    import copy
    from fishbirdeyevisualslam_torch.device import to_device
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc

    if first is None:
        first = {}
        phase_loop(torch, cfg, dev, keep=first)
    cfg_s = cfg.replace(flags=dataclasses.replace(cfg.flags, fix_scale=False))
    rcfg = cfg_s.replace(tracking=dataclasses.replace(cfg_s.tracking, loop_odom_vet=False))
    names = ("correct_loop", "optimize_sim3_pose_graph", "search_and_fuse", "global_ba")

    def replay(d, timed=None):
        closer = lc.LoopCloser(rcfg)
        closer.__dict__.update(copy.deepcopy(first["closer"]) | {"cfg": rcfg})
        tried = []
        with loop_attempts(torch, d, lc, tried), \
                (sync_timers(torch, d, lc, names, timed) if timed is not None
                 else contextlib.nullcontext()):
            m, closed = closer.process_keyframe(to_device(first["m"], d), first["cur"])
        return m, closed, tried[-1] if tried else None

    timed = []
    runs = [replay(dev, timed), replay(dev)]
    diff = [k for k, x, y in zip(runs[0][0]._fields, runs[0][0], runs[1][0])
            if not torch.equal(x, y)]
    cpu = {}

    def cpu_replay():
        t1, cpu["timed"] = time.perf_counter(), []
        try:
            cpu["run"] = replay(torch.device("cpu"), cpu["timed"])
        except BaseException as e:   # noqa: BLE001 (raised again in the main thread)
            cpu["error"] = e
        cpu["s"] = time.perf_counter() - t1

    worker = threading.Thread(target=cpu_replay, name="cpu replay")
    worker.start()
    try:
        launches = drive_session_sim3(torch, cfg, cfg_s, dev, snap)
    finally:
        worker.join()
    if "error" in cpu:
        raise cpu["error"]
    c = cpu["run"]
    a = runs[0][2]
    d = map_diff(torch, cfg, runs[0][0], c[0], first["cur"])
    print(f"[sim3] phase 7's correction with fix_scale = False and the vet off: closed "
          f"{runs[0][1]}, keyframe frame {a and a['frame']} with candidate frame "
          f"{a and a['cand_frame']}, {a and a['n_inliers']} RANSAC inliers, "
          f"{a and a['n_proj']} projected matches; on the card: stages (synchronised ms) "
          f"{[(x[0], round(x[1], 1)) for x in timed]}; twice on the card, fields that differ "
          f"{diff}; on the CPU, beside the drives ({cpu['s']:.1f} s; stages, ms: "
          f"{[(x[0], round(x[1])) for x in cpu['timed']]}): closed {c[1]}, candidate frame "
          f"{c[2] and c[2]['cand_frame']}, {describe_diff(d)} (bounds: bit-identical, the "
          f"same candidate, poses within 1e-3, front points p99 <= {PX99_BOUND} px)", flush=True)
    if diff or not (runs[0][1] and c[1] and c[2]["cand"] == a["cand"]):
        fail("the Sim3 loop correction is not reproduced")
    if not (d["dT"] <= 1e-3 and d["px99"] <= PX99_BOUND):
        fail("the Sim3 loop correction on the card and on the CPU disagree")
    return launches


def drive_session_sim3(torch, cfg, cfg_s, dev, snap):
    """Phase 9's drives: the resumed session and the ``fix_scale = False``
    arc (``cfg_s``), with their checks; returns their kernel launches."""
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.io.session import load_session
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    seq, sync, session = snap["seq"], snap["sync"], snap["session"]
    t1 = time.perf_counter()
    r = load_session(io.BytesIO(session), cfg, device=dev)
    t_load = time.perf_counter() - t1
    _drive(r, seq, range(N_RESUME, N_MAP))
    got, want = r.frame_trajectory_Twb(), sync.frame_trajectory_Twb()
    dmax = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    diff = _same_run(torch, r, sync)
    print(f"[session] saved after {N_RESUME} frames ({len(session) / 1e6:.1f} MB npz), loaded in "
          f"{t_load:.2f} s, {N_MAP - N_RESUME} more frames: trajectory against the "
          f"uninterrupted drive max |diff| {dmax:.3g} (bound {RESUME_BOUND}), fields that "
          f"differ {diff}", flush=True)
    if not dmax <= RESUME_BOUND:
        fail("the resumed drive differs from the uninterrupted one")

    s = SlamSystem(cfg_s, device=dev)
    _drive(s, seq, range(N_MAP))
    states = [e.state for e in s.trajectory]
    ate = evaluate.ate_rmse_vs_gt(s.frame_trajectory_Twb(), seq.gt[:N_MAP])
    ini = next((i for i, x in enumerate(states) if x == tr.OK), None)
    print(f"[sim3] the arc with fix_scale = False: states {states}, loops closed "
          f"{s.n_loops_closed}, ATE {ate:.4f} m (bound {SIM3_ATE_BOUND} m)", flush=True)
    if ini is None or any(x != tr.OK for x in states[ini:]) or not ate < SIM3_ATE_BOUND:
        fail("the fix_scale = False arc lost tracking or missed its ATE bound")
    launches = {c.__name__: c.launches for c in counters}
    if dev.type == "cuda" and any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    return launches


def check_dataset(cfg, snap):
    """Phase 5's render exported by the port's ``export_sequence`` as binary
    PGM and read back through ``DatasetSequence.iter_prefetched`` (the native
    prefetcher): every image equal to the render as uint8 (PGM's type), the
    masks to the reader's preprocessing of the render's, exactly."""
    import tempfile
    from fishbirdeyevisualslam_torch.io import dataset
    from fishbirdeyevisualslam_torch.runtime import native
    seq = snap["seq"]
    q = lambda a: np.clip(np.asarray(a, np.float32), 0, 255).astype(np.uint8).astype(np.float32)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        dataset.export_sequence(seq, root, fmt="pgm")
        ds = dataset.DatasetSequence.open(root, ext=".pgm", bird_cfg=cfg.bird)
        ds.crop, ds.downsample = None, 1
        bad, n, worst = [], 0, 0.0
        for i, fr in enumerate(ds.iter_prefetched()):
            src = seq.frames[i]
            n += 1
            for k in ("front", "bird", "contour"):
                if not np.array_equal(fr[k], q(src[k])):
                    bad.append((i, k))
                worst = max(worst, float(np.abs(fr[k] - np.asarray(src[k], np.float32)).max()))
            if not np.array_equal(fr["mask"], dataset.preprocess_bird_mask(src["mask"], cfg.bird)):
                bad.append((i, "mask"))
            if np.abs(fr["odom"] - seq.odom[i]).max() > 1e-5:
                bad.append((i, "odom"))
    print(f"[dataset] {len(seq.frames)} frames exported as PGM and read back through the native "
          f"prefetcher ({native.library_path().name}) in {time.perf_counter() - t1:.1f} s: {n} "
          f"frames, mismatches {bad} (bound: none; images equal to the render as uint8, whose "
          f"largest change from the f32 render is {worst:.3g})", flush=True)
    if bad or n != len(seq.frames):
        fail("the dataset round trip is not exact")


# ---------------------------------------------------------------------------
# phase 10: the switches, the contour, degraded renders, the demo, the odometer
# ---------------------------------------------------------------------------

N_FLAG = 10          # the JAX flag tests' 10-frame arc at 0.5 m (tests/test_e2e_flags.py:23)
FLAG_ATE_BOUND = 0.3           # m: tests/test_e2e_flags.py:45,49, tests/test_e2e_knobs.py:43
N_SOAK, SOAK_STEP = 36, 0.4    # tests/test_e2e_capacity.py:32
N_DEGRADED = 12                # tests/test_e2e.py:70
DEGRADED_ATE_BOUND = 0.4       # m: tests/test_e2e.py:80
N_DEMO = 10                    # frames of the demo drive (tests/test_e2e.py:30's arc)
DEMO_ATE_BOUND = 0.15          # m: tests/test_e2e.py:50
N_ODOM, ODOM_STEP = 8, 0.3     # tests/test_bird_odometer.py:27-38
ODOM_STEP_TOL = 0.12           # m: tests/test_bird_odometer.py:38
N_REAL = 80                    # tests/test_realism.py:79-92: the 80-frame circle
REAL_MIN_OK, REAL_ATE_BOUND = 50, 0.25


def reduced_cfg(**capacity):
    """``tests/e2e_common.py:e2e_config`` from the port's own config: K = 64,
    P = 8192, PB = 4096, local windows of 2048 / 1024 points."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    cfg = SystemConfig()
    kw = dict(max_keyframes=64, max_points=8192, max_bird_points=4096, max_local_points=2048,
              max_local_bird_points=1024)
    kw.update(capacity)
    return cfg.replace(capacity=dataclasses.replace(cfg.capacity, **kw))


def timed_drive(torch, cfg, dev, seq, contour: bool = False):
    """The facade over ``seq`` (with its contour images where asked), each
    frame synchronised: (facade, states, ATE, median ms per frame, each
    frame's route)."""
    from fishbirdeyevisualslam_torch.io import evaluate
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    s = SlamSystem(cfg, device=dev)
    ms, routes = [], []
    for i, fr in enumerate(seq.frames):
        _sync(torch, dev)
        t0 = time.perf_counter()
        s.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"],
                contour=fr["contour"] if contour else None)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        routes.append(s.last_route)
    s.finish()
    states = [e.state for e in s.trajectory]
    ate = evaluate.ate_rmse_vs_gt(s.frame_trajectory_Twb(), seq.gt)
    return s, states, ate, statistics.median(ms), routes


def drive_line(label: str, s, states, ate: float, ms: float, routes, extra: str = "") -> str:
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    return (f"[flags] {label}: {sum(x == tr.OK for x in states)}/{len(states)} frames OK, "
            f"states {states}, routes {dict(collections.Counter(routes))}, ATE {ate:.4f} m, "
            f"{int(s.map.kf_valid.sum()) if s.map is not None else 0} keyframes live "
            f"({int(s.map.kf_counter) if s.map is not None else 0} inserted), "
            f"{ms:.1f} ms per frame (median, synchronised){extra}")


def _png_ok(path: str) -> bool:
    import zlib
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return False
    n = int.from_bytes(data[8:12], "big")
    w, h = (int.from_bytes(data[16 + 4 * i:20 + 4 * i], "big") for i in range(2))
    idat = data.index(b"IDAT")
    m = int.from_bytes(data[idat - 4:idat], "big")
    return n == 13 and len(zlib.decompress(data[idat + 4:idat + 4 + m])) == h * (1 + 3 * w)


def phase_flags(torch, dev):
    """The drives of the JAX package's flag, knob, capacity and degraded e2e
    tests at ``reduced_cfg``'s capacity, each held to that test's bound:
    ``have_bird``, ``tight_couple`` and ``loose_couple`` off and
    ``reference_parity()`` over the 10-frame arc; 8 keyframe slots with a
    keyframe every 2 frames over a 36-frame arc; 12 degraded frames with
    their contour images.  Then the port's demo (default config, contour on,
    10 frames, its files under a temporary prefix), the bird odometer (NDT
    and ICP) on the card against its CPU route, and ``filter_ipm_edges`` on
    the card against the CPU.  Returns the kernel launches of the drives."""
    import tempfile
    from fishbirdeyevisualslam_torch import SystemConfig, demo, reference_parity
    from fishbirdeyevisualslam_torch.io import synthetic
    from fishbirdeyevisualslam_torch.ops.edge_filter import filter_ipm_edges
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.bird_odometer import BirdOdometer

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    base = reduced_cfg()
    OK = tr.OK
    arc = render_sequence(base, N_FLAG, "arc", 0.5, check=(N_FLAG - 1,))

    def flagged(**kw):
        return base.replace(flags=dataclasses.replace(base.flags, **kw))

    s, st, ate, ms, routes = timed_drive(torch, flagged(have_bird=False), dev, arc)
    n_bp = int(s.map.bp_valid.sum()) if s.map is not None else -1
    print(drive_line("have_bird off", s, st, ate, ms, routes, f", {n_bp} bird points valid "
                     f"(bounds: last frame OK, no bird point, ATE < {FLAG_ATE_BOUND} m)"), flush=True)
    if not (st[-1] == OK and n_bp == 0 and ate < FLAG_ATE_BOUND):
        fail("the have_bird = False drive missed its bounds")
    s, st, ate, ms, routes = timed_drive(torch, flagged(tight_couple=False), dev, arc)
    print(drive_line("tight_couple off", s, st, ate, ms, routes,
                     f" (bounds: last frame OK, ATE < {FLAG_ATE_BOUND} m)"), flush=True)
    if not (st[-1] == OK and ate < FLAG_ATE_BOUND):
        fail("the tight_couple = False drive missed its bounds")
    s, st, ate, ms, routes = timed_drive(torch, flagged(loose_couple=False), dev, arc)
    print(drive_line("loose_couple off", s, st, ate, ms, routes,
                     " (bound: at least 5 frames OK; the scale is free)"), flush=True)
    if sum(x == OK for x in st) < 5:
        fail("the loose_couple = False drive tracked fewer than 5 frames")
    parity = reference_parity()
    cfg_p = base.replace(bird=parity.bird, ba=parity.ba, tracking=parity.tracking)
    s, st, ate, ms, routes = timed_drive(torch, cfg_p, dev, arc)
    print(drive_line("reference_parity()", s, st, ate, ms, routes,
                     f" (bounds: last frame OK, ATE < {FLAG_ATE_BOUND} m)"), flush=True)
    if not (st[-1] == OK and ate < FLAG_ATE_BOUND):
        fail("the reference_parity() drive missed its bounds")

    soak_cfg = reduced_cfg(max_keyframes=8)
    soak_cfg = soak_cfg.replace(tracking=dataclasses.replace(soak_cfg.tracking,
                                                             max_frames_between_kf=2))
    soak = render_sequence(soak_cfg, N_SOAK, "arc", SOAK_STEP)
    s, st, ate, ms, routes = timed_drive(torch, soak_cfg, dev, soak)
    inserted, live = int(s.map.kf_counter), int(s.map.kf_valid.sum())
    n_bad = sum(x != OK for x in st)
    print(drive_line("capacity soak (K = 8, a keyframe every 2 frames)", s, st, ate, ms, routes,
                     f" (bounds: more than 10 inserted, at most 8 live, last frame OK, at most 6 "
                     f"frames not OK, ATE < {FLAG_ATE_BOUND} m)"), flush=True)
    if not (inserted > 10 and live <= 8 and st[-1] == OK and n_bad <= 6
            and ate < FLAG_ATE_BOUND):
        fail("the capacity soak missed its bounds")

    deg = render_sequence(base, N_DEGRADED, "arc", 0.5, degrade=synthetic.DegradeConfig())
    s, st, ate, ms, routes = timed_drive(torch, base, dev, deg, contour=True)
    print(drive_line("degraded, with the contour", s, st, ate, ms, routes,
                     f" (bounds: at least 7 frames OK, ATE < {DEGRADED_ATE_BOUND} m)"), flush=True)
    if not (sum(x == OK for x in st) >= 7 and ate < DEGRADED_ATE_BOUND):
        fail("the degraded drive missed its bounds")
    lap("phase 10's facade drives")

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "demo")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            stats = demo.main(["--frames", str(N_DEMO), "--out-prefix", prefix]
                              + (["--cpu"] if dev.type == "cpu" else []),
                              render=pooled_render(SystemConfig(), N_DEMO))
        dt = time.perf_counter() - t0
        text = out.getvalue()
        printed = json.loads(text[text.index("{"):text.rindex("}") + 1])
        files = {k: os.path.getsize(prefix + k) if os.path.exists(prefix + k) else 0
                 for k in ("_map.png", "_traj.tum")}
        png_ok = files["_map.png"] > 0 and _png_ok(prefix + "_map.png")
        st = stats["states"]
        print(f"[flags] the demo (default config at full capacity, contour on, {N_DEMO} frames): "
              f"{dt:.1f} s; states {st}; stats "
              f"{json.dumps({k: v for k, v in printed.items() if k != 'timing'})}, "
              f"{printed['timing']['median_s'] * 1e3:.1f} ms per frame (median); files {files}, "
              f"the PNG decodes: {png_ok} (bounds: last frame OK, at least 7 OK, at least 3 "
              f"keyframes, ATE < {DEMO_ATE_BOUND} m)", flush=True)
    if not (st[-1] == OK and sum(x == OK for x in st) >= 7 and printed["n_keyframes"] >= 3
            and printed["ate_rmse_m"] < DEMO_ATE_BOUND and png_ok and files["_traj.tum"] > 0):
        fail("the demo missed its bounds")
    launches = {c.__name__: c.launches for c in counters}
    lap("the demo")

    cfg = SystemConfig()
    world = synthetic.make_world(4)
    renders = []
    for p in synthetic.make_trajectory(N_ODOM, kind="straight", step=ODOM_STEP):
        bird = synthetic.render_bird(world, cfg, p)
        mask, _ = synthetic.bird_mask_and_contour(cfg, bird)
        renders.append((bird.astype(np.float32), mask.astype(np.float32)))
    for method in ("ndt", "icp"):
        poses, ms = {}, []
        for d in (dev, torch.device("cpu")):
            odo = BirdOdometer(cfg, method=method, device=d)
            out_p = []
            for b, m in renders:
                _sync(torch, dev)
                t0 = time.perf_counter()
                out_p.append(odo.add_new_frame(b, m))
                if d.type == dev.type:
                    ms.append((time.perf_counter() - t0) * 1e3)
            poses[d.type] = np.stack(out_p)
        step = np.linalg.norm(np.diff(poses[dev.type][:, :2], axis=0), axis=1)
        dmax = float(np.abs(poses[dev.type] - poses["cpu"]).max())
        print(f"[flags] BirdOdometer ({method}) over {N_ODOM} frames at {ODOM_STEP} m: steps "
              f"{np.round(step, 4).tolist()} m, card against the CPU route max |diff| {dmax:.3g} "
              f"(bounds: each step after the first within {ODOM_STEP_TOL} m of {ODOM_STEP} m, "
              f"1e-4); {statistics.median(ms):.1f} ms per frame on the card (median)", flush=True)
        if not (np.all(np.abs(step[1:] - ODOM_STEP) < ODOM_STEP_TOL) and dmax <= 1e-4):
            fail(f"the bird odometer ({method}) missed its bounds")
    b, m = renders[0]
    want = filter_ipm_edges(torch.from_numpy(b), torch.from_numpy(m * 255.0))
    bd, md = torch.from_numpy(b).to(dev), torch.from_numpy(m * 255.0).to(dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    got = filter_ipm_edges(bd, md)
    _sync(torch, dev)
    ms_f = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    print(f"[flags] filter_ipm_edges on a {b.shape[0]}x{b.shape[1]} bird render: card equal to "
          f"the CPU route {same}, {int(want[1].sum())} bird edge pixels, {ms_f:.1f} ms on the "
          f"card (synchronised, first call)", flush=True)
    if not same:
        fail("filter_ipm_edges on the card differs from the CPU route")
    print("[flags] kernel launches over the facade drives and the demo: " + json.dumps(launches),
          flush=True)
    if dev.type == "cuda" and any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    return launches


def pooled_real_render(cfg, n_frames: int):
    """A ``render(world, cfg_true, gt)`` for ``realism.make_real_sequence``
    that renders its frames in the pool."""
    def pooled(world, cfg_true, gt):
        try:
            return _pool_map(_render_real_frame, n_frames, cfg=cfg, cfg_true=cfg_true, gt=gt,
                             world=world)
        finally:
            _RENDER.clear()
    return pooled


def phase_realism(torch, dev):
    """``tests/test_realism.py``'s E2E (``TestRealismE2E``): the facade over
    the 80-frame model-violating circle (odometry noise 0.02, seed 0, the
    contour images passed) at ``reduced_cfg``'s capacity; at least 50 frames
    OK and ATE < 0.25 m.  Frames 0 and 79 are rendered again serially and
    must be equal."""
    from fishbirdeyevisualslam_torch.io import realism, synthetic
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    cfg = reduced_cfg()
    t0 = time.perf_counter()
    seq = realism.make_real_sequence(cfg, n_frames=N_REAL, kind="circle", odom_noise=0.02, seed=0,
                                     render=pooled_real_render(cfg, N_REAL))
    dt = time.perf_counter() - t0
    gt = synthetic.make_trajectory(N_REAL, "circle", step=0.35, seed=0)
    world = realism.make_real_world(cfg, realism.RealismConfig(), 0, traj=gt)
    cfg_true = realism._perturbed_cfg(cfg, realism.RealismConfig(), 0)
    for i in (0, N_REAL - 1):
        ref = realism.render_real_frame(world, cfg, cfg_true, gt[i], i)
        if not all(np.array_equal(seq.frames[i][k], ref[k]) for k in ref):
            fail(f"frame {i} of the pooled realism render differs from its serial render")
    print(f"[realism] {N_REAL}-frame model-violating circle rendered in {dt:.1f} s; frames 0 "
          f"and {N_REAL - 1} equal to their serial render", flush=True)
    s, st, ate, ms, routes = timed_drive(torch, cfg, dev, seq, contour=True)
    n_ok = sum(x == tr.OK for x in st)
    print(drive_line("the realism circle", s, st, ate, ms, routes,
                     f" (bounds: at least {REAL_MIN_OK} frames OK, ATE < {REAL_ATE_BOUND} m)")
          .replace("[flags]", "[realism]"), flush=True)
    if not (n_ok >= REAL_MIN_OK and ate < REAL_ATE_BOUND):
        fail("the realism drive missed its bounds")


# ---------------------------------------------------------------------------
# phase 11: the multi-device layer and the functions nothing in the system calls
# ---------------------------------------------------------------------------

N_BATCH = 16                  # kernel 5 over a batch: problems of phase 2's shape
BA_ITERS = (5, 10)            # the sharded global BA's LM stages (scripts/bench_scaling.py)
SHARDED_BOUND = 5e-2          # max |d pose| of two ranks against one (scripts/bench_scaling.py:143)
RANK_TIMEOUT = 150.0          # s: a rank of the two-rank run that takes longer fails the phase
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                      "torch_multiprocess_ba_worker.py")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _synced_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def two_rank_ba(tmp: str) -> list:
    """The sharded global BA at full width over two processes on the one card
    (gloo carrying CUDA tensors).  Returns each rank's result (an npz).
    A rank that fails or outlives RANK_TIMEOUT fails the phase; both are
    killed on the way out."""
    port = _free_port()
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port), outs[r],
                               "--device", "cuda", "--problem", "realistic", "--iters",
                               *map(str, BA_ITERS)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.perf_counter() + RANK_TIMEOUT
    logs = []
    try:
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                fail(f"rank {r} of the two-rank BA ran past {RANK_TIMEOUT:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-3000:], flush=True)
            fail(f"rank {r} of the two-rank BA exited with {p.returncode}")
    return [dict(np.load(o)) for o in outs]


def phase_parallel(torch, cfg, dev, st):
    """Phase 11: the sharded global BA at full width (a one-rank NCCL group
    bit-identical to ``bundle_adjust``; two processes on the card over gloo
    within SHARDED_BOUND of it), kernel 5 over a batch of N_BATCH problems
    (bit-identical to single launches, each row within phase 2's bounds of
    the plain LM, the graph time of one batched launch against N_BATCH
    single ones), ``match_map_points_dual`` on phase 3's map against the ids
    form and the plain matcher, and ``extract`` against the views of
    ``extract_dual``.  The drive whose launches count is the entry point
    ``batched_pose_optimization``.  Returns (launches, the batched kernel's
    row)."""
    import tempfile
    import torch.distributed as dist
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.ops import features
    from fishbirdeyevisualslam_torch.parallel import sharded_ba
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    from fishbirdeyevisualslam_torch.solvers.ba import bundle_adjust
    from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_multiprocess_ba_worker as worker

    t_phase = time.perf_counter()
    F, FB = cfg.capacity.max_front_kp, cfg.capacity.max_bird_kp
    probs = [pose_problem(torch, cfg, dev, F, FB, seed) for seed in range(N_BATCH)]
    T0 = se3.identity((N_BATCH,), device=dev)
    front = FrontObs(*(torch.stack(x) for x in zip(*(p[1] for p in probs))))
    bird = BirdObs(*(torch.stack(x) for x in zip(*(p[2] for p in probs))))
    prob = worker.realistic_problem(cfg, dev)
    K, P, PB = prob[0].shape[0], prob[2].Xw.shape[0], prob[3].Xw.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = sharded_ba.make_mesh(device=dev)
            sharded_ba.distributed_bundle_adjust(cfg, mesh, *prob, *BA_ITERS)  # warm-up
            ref, ref_ms = _synced_ms(torch, lambda: bundle_adjust(
                cfg.camera, cfg.ba, *prob, n_iters_1=BA_ITERS[0], n_iters_2=BA_ITERS[1]))
            one, one_ms = _synced_ms(torch, lambda: sharded_ba.distributed_bundle_adjust(
                cfg, mesh, *prob, *BA_ITERS))
            # the drive: the entry point, with the counts from 0
            cuda_pose_opt.pose_optimization_batched.launches = 0
            out = sharded_ba.batched_pose_optimization(cfg, mesh, T0, front, bird)
            torch.cuda.synchronize()
            launches = {"pose_optimization_batched":
                        cuda_pose_opt.pose_optimization_batched.launches}
        finally:
            dist.destroy_process_group()
        same = all(torch.equal(x, y) for x, y in zip(one, ref))
        print(f"[parallel] sharded global BA, K={K} P={P} PB={PB} M={prob[2].kf_idx.shape[1]}, "
              f"{BA_ITERS[0]} + {BA_ITERS[1]} iterations (warm): bundle_adjust {ref_ms:.1f} ms, "
              f"one rank over NCCL {one_ms:.1f} ms, bit-identical: {same}; poses moved by up "
              f"to {(ref.poses - prob[0]).abs().max().item():.4g} (the map's poses and its "
              f"odometry disagree)", flush=True)
        if not same:
            fail("the one-rank sharded BA differs from bundle_adjust")
        t_ranks = time.perf_counter()
        ranks = two_rank_ba(tmp)
        t_ranks = time.perf_counter() - t_ranks
    d_ranks = float(np.abs(ranks[0]["poses"] - ranks[1]["poses"]).max())
    d_one = float(np.abs(ranks[0]["poses"] - one.poses.cpu().numpy()).max())
    d_pts = np.abs(ranks[0]["front_Xw"] - one.front_Xw.cpu().numpy()).max(-1)
    flips = float((ranks[0]["front_inlier"] != one.front_inlier.cpu().numpy()).mean())
    print(f"[parallel] two ranks on the card over gloo: {float(ranks[0]['ms']):.1f} / "
          f"{float(ranks[1]['ms']):.1f} ms (after a warm-up run; {t_ranks:.1f} s with the "
          f"processes' start); ranks differ by {d_ranks:.3g}; max |d pose| against one rank "
          f"{d_one:.4g} (bound {SHARDED_BOUND}); front points against one rank: median "
          f"{np.median(d_pts):.3g}, p99 {np.percentile(d_pts, 99):.3g}, max {d_pts.max():.4g} m; "
          f"front inlier flags flipped {flips:.4%}", flush=True)
    if d_ranks != 0.0 or not all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]
                                 if k != "ms"):
        fail("the two ranks of the sharded BA disagree")
    if not d_one <= SHARDED_BOUND:
        fail("the two-rank sharded BA is off the one-rank run")
    t_ba = time.perf_counter() - t_phase

    # kernel 5 over the batch: against single launches and the plain LM
    if launches["pose_optimization_batched"] == 0:
        fail("batched_pose_optimization never launched the batched pose kernel")
    singles = [cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0[b], p[1], p[2])
               for b, p in enumerate(probs)]
    if not all(torch.equal(x[b], y) for b, s in enumerate(singles) for x, y in zip(out, s)):
        fail("the batched pose kernel differs from single launches")
    # the plain LM of every row: timed in a graph, its one warm-up call the reference
    plain = []
    plain_ms = time_ms(torch, lambda: cuda_pose_opt.pose_optimization_batched_plain(
        cfg.camera, cfg.ba, T0, front, bird), iters=3, warmup=1, out=plain)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(N_BATCH):
        d = pose_diff(out.Tcw[b], plain[0].Tcw[b])
        ff = (out.front_inlier[b] != plain[0].front_inlier[b]).float().mean().item()
        bf = (out.bird_inlier[b] != plain[0].bird_inlier[b]).float().mean().item()
        dn = abs(int(out.n_inliers[b]) - int(plain[0].n_inliers[b]))
        if not (d <= 1e-3 and ff < 0.02 and bf < 0.02 and dn <= 5):
            fail(f"row {b} of the batched pose kernel differs from the plain LM: pose {d:.3g}, "
                 f"flips {ff:.4f} / {bf:.4f}, n_inliers {dn}")
        err = max(err, d)
    evals = cfg.ba.pose_rounds * (cfg.ba.pose_iters + 1)
    n_act = int(front.valid.sum()) + int(bird.valid.sum())
    ops = evals * n_act * 200 + cfg.ba.pose_rounds * (front.valid.numel()
                                                      + bird.valid.numel()) * 35
    nbytes = N_BATCH * (F * (6 * 4 + 1 + 1) + FB * (7 * 4 + 1 + 1) + 7 * 4 * 3)
    b_ms, b_by = bound(nbytes, ops, PEAK_F32)
    row = dict(name="pose_optimization_batched",
               source="fishbirdeyevisualslam_torch/csrc/pose_opt.cu",
               replaces="fishbirdeyevisualslam_tpu/solvers/pallas_pose_opt.py:387",
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
               plain_ms=plain_ms)
    time_row(torch, row, f"pose_optimization_batched, B = {N_BATCH}",
             lambda: cuda_pose_opt.pose_optimization_batched(cfg.camera, cfg.ba, T0, front, bird))
    row["singles_ms"] = time_ms(torch, lambda: [cuda_pose_opt.pose_optimization(
        cfg.camera, cfg.ba, T0[b], p[1], p[2]) for b, p in enumerate(probs)])
    print(f"[parallel] pose_optimization_batched: B={N_BATCH} x (N={F}, NB={FB}): bit-identical "
          f"to {N_BATCH} single launches, within {err:.3g} of the plain LM; graph "
          f"{row['ms']:.4f} ms, kernel's own {row['kernel_ms']:.4f} ms, against {N_BATCH} single "
          f"launches {row['singles_ms']:.4f} ms (plain {row['plain_ms']:.2f} ms, bound "
          f"{b_ms:.5f} ms by {b_by}); {cuda_pose_opt.max_active_clusters()} clusters of 8 "
          f"resident at once; launches over the drive: {json.dumps(launches)}", flush=True)
    t_batch = time.perf_counter() - t_phase - t_ba

    # match_map_points_dual on phase 3's map, and extract on one view
    m, last_mp = st.start[0], st.start[2]
    f, T_pred = st.build(0), st.start[5]
    cand = torch.cat([last_mp, m.kf_mp[0]])
    mask = torch.zeros(m.mp_pos.shape[0], dtype=torch.bool, device=dev)
    mask[cand[cand >= 0].long()] = True
    th = float(cfg.matcher.th_high)
    got = tr.match_map_points_dual(m, f, cfg, T_pred, mask, 15.0, th)
    ids = torch.unique(cand[cand >= 0])            # ascending, the mask's order
    alt = tr.match_map_points_dual_ids(m, f, cfg, T_pred, ids, 15.0, th, True)
    plain = tr.match_map_points_dual(m, f, cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, use_fused_matcher=False)), T_pred, mask, 15.0, th)
    for label, other in (("the ids form", alt), ("the plain matcher", plain)):
        if not all(torch.equal(x, y) for r, o in zip(got, other) for x, y in zip(r, o)):
            fail(f"match_map_points_dual differs from {label}")
    print(f"[parallel] match_map_points_dual on phase 3's map (P={mask.shape[0]}, "
          f"{int(mask.sum())} candidates): {int(got[0].count)} / {int(got[1].count)} matches at r / 2r, equal to "
          f"the ids form and to the plain matcher", flush=True)
    bmask = torch.ones(st.bird.shape, dtype=torch.bool, device=dev)
    bmask[:40] = False
    dual = features.extract_dual(st.front, st.bird, cfg.orb, F, FB, mask_b=bmask)
    views = (features.extract(st.front, cfg.orb, F),
             features.extract(st.bird, cfg.orb, FB, detection_mask=bmask))
    for name, a, b in zip(("front", "bird"), views, dual):
        diff = [k for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
        print(f"[parallel] extract, {name} view: {int(a.valid.sum())} keypoints; fields that "
              f"differ from extract_dual's view: {diff or 'none'}", flush=True)
        if diff:
            fail(f"extract differs from the {name} view of extract_dual")
    t_all = time.perf_counter() - t_phase
    print(f"[parallel] phase 11: {t_all:.1f} s (the sharded BA {t_ba:.1f}, of which the two "
          f"ranks {t_ranks:.1f}; the batched kernel {t_batch:.1f}; the match and extract "
          f"{t_all - t_ba - t_batch:.1f})", flush=True)
    return launches, row


_LAP = [T_START]


def lap(label: str) -> None:
    """Print the script's wall time at the end of ``label`` and that part's own."""
    now = time.perf_counter()
    print(f"[wall] {label} done at {now - T_START:.1f} s ({now - _LAP[0]:.1f} s)", flush=True)
    _LAP[0] = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and hold them against their plain versions only")
    ap.add_argument("--profile", action="store_true",
                    help="also print the profiled frame's op table")
    ap.add_argument("--facade-only", action="store_true",
                    help="build the kernels and run phase 5, the facade drive, only (no result "
                         "lines)")
    ap.add_argument("--recovery-only", action="store_true",
                    help="build the kernels and run phase 6, recovery, only (no result lines)")
    ap.add_argument("--loop-only", action="store_true",
                    help="build the kernels and run phase 7, loop closing, only (no result "
                         "lines)")
    ap.add_argument("--async-only", action="store_true",
                    help="build the kernels and run phases 8 and 9 (asynchronous mapping, "
                         "sessions, the Sim3 correction) and the dataset check only (no result "
                         "lines)")
    ap.add_argument("--flags-only", action="store_true",
                    help="build the kernels and run phase 10 (the switches, the contour, "
                         "degraded renders, the demo, the bird odometer) only (no result lines)")
    ap.add_argument("--realism-only", action="store_true",
                    help="build the kernels and drive the 80-frame model-violating circle of "
                         "tests/test_realism.py only (no result lines)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build the kernels and run phase 11 (the sharded global BA on one and "
                         "two ranks, kernel 5 over a batch, match_map_points_dual, extract) only "
                         "(no result lines)")
    ap.add_argument("--survey", action="store_true",
                    help="build the kernels, drive phase 5 and hold the mapping step of every "
                         "fourth keyframe against the CPU, only (no result lines)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from fishbirdeyevisualslam_torch import SystemConfig, _cuda

    dev = torch.device("cuda", 0)
    card = smi()
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True, text=True)
    print(f"[toolchain] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; nvcc: {nvcc.stdout.strip().splitlines()[-1]}",
          flush=True)
    t0 = time.perf_counter()
    report = _cuda.build()
    print(f"[build] {len(report)} sources in {time.perf_counter() - t0:.1f} s (parallel): "
          + ", ".join(f"{k} {v[0]:.1f} s" for k, v in report.items()), flush=True)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    cfg = SystemConfig()
    if args.facade_only or args.survey:
        phase_facade(torch, cfg, dev, profile=args.profile, survey=args.survey)
        return 0
    if args.recovery_only:
        phase_recovery(torch, cfg, dev, profile=args.profile)
        return 0
    if args.loop_only:
        phase_loop(torch, cfg, dev, profile=args.profile)
        return 0
    if args.flags_only:
        phase_flags(torch, dev)
        lap("phase 10")
        return 0
    if args.realism_only:
        phase_realism(torch, dev)
        lap("the realism drive")
        return 0
    if args.parallel_only:
        st = Stream(torch, cfg, dev, 1)
        lap("the build and phase 3's map")
        phase_parallel(torch, cfg, dev, st)
        lap("phase 11")
        return 0
    if args.async_only:
        snap = sync_drive(torch, cfg, dev)
        lap("phase 5's drive")
        phase_async(torch, cfg, dev, snap)
        lap("phase 8")
        phase_session_sim3(torch, cfg, dev, snap)
        lap("phase 9")
        check_dataset(cfg, snap)
        print(f"[wall] {time.perf_counter() - T_START:.1f} s", flush=True)
        return 0
    rows = phase_kernels(torch, cfg, dev)
    st = Stream(torch, cfg, dev, N_STREAM + N_PHASE + 2)
    rows.update(phase_pose_and_hamming(torch, cfg, dev, st))
    launches = {}
    if not args.kernels_only:
        slice_launches, fps, activities = phase_slice(torch, cfg, dev, st, args.profile)
        print(f"[slice] per frame: {fps:.2f} frames/s, {activities} device activities, "
              f"{slice_launches['pose_optimization'] / N_STREAM:g} pose kernel launches",
              flush=True)
        # the table's launches are those of the entry point's drives (phases
        # 5-10), each counted from 0 over its own drive
        snap, first = {}, {}
        lap("phases 1-4")
        per_phase = [phase_facade(torch, cfg, dev, profile=args.profile, snap=snap)[0]]
        lap("phase 5")
        per_phase.append(phase_recovery(torch, cfg, dev, snap, profile=args.profile))
        lap("phase 6")
        per_phase.append(phase_loop(torch, cfg, dev, profile=args.profile, keep=first))
        lap("phase 7")
        per_phase.append(phase_async(torch, cfg, dev, snap))
        lap("phase 8")
        per_phase.append(phase_session_sim3(torch, cfg, dev, snap, first))
        lap("phase 9")
        check_dataset(cfg, snap)
        per_phase.append(phase_flags(torch, dev))
        lap("phase 10")
        launches = {k: sum(p[k] for p in per_phase) for k in per_phase[0]}
        batched_launches, rows["pose_opt_batched"] = phase_parallel(torch, cfg, dev, st)
        launches.update(batched_launches)
        lap("phase 11")
        print("[drives] kernel launches (phase 5, 6, 7, 8 free-running, 9 resume + fix_scale "
              "arc, 10 switches + demo): "
              + json.dumps({k: [p[k] for p in per_phase] for k in per_phase[0]}), flush=True)
    by_name = {"fast": "fast_detect_levels", "patch": "extract_patches",
               "match_dual": "fused_projection_match_dual", "match": "fused_projection_match",
               "pose_opt": "pose_optimization", "hamming": "hamming_matrix_packed",
               "masked_match": "fused_masked_match"}
    if "pose_opt_batched" in rows:
        by_name["pose_opt_batched"] = "pose_optimization_batched"
    kernels = []
    for key, fn_name in by_name.items():
        row = dict(rows[key], route="cuda", launches=launches.get(fn_name, 0))
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "kernel_ms", "plain_ms",
                                            "bound_ms", "bound_by", "dense_bound_ms",
                                            "singles_ms", "library_ms") if k in row})
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(f"[wall] {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
