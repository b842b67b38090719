#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``fishbirdeyevisualslam_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py                 # all phases (one card, nvcc)
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --profile       # all phases + the profiled frame's op table

Phases, each printing its lines:
  1. the card and the toolchain; the kernels built from
     fishbirdeyevisualslam_torch/csrc/ (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with the device time of both (CUDA graph replays timed by
     CUDA events) and the kernel's own device time (the profiler's device
     activities of the port's own kernels over the same replays): FAST, the
     patch gather and both projection matchers; the fused pose optimisation
     on a stream frame's own inputs and on a synthetic problem, timed at
     (rounds, iters) = (1, 0), (1, 10) and (4, 10); the packed Hamming matrix
     and masked match at scripts/bench_matcher.py's shapes;
  3. the per-frame slice (build_frame + track_frame_core) at full width
     with the default SystemConfig, a 32-frame stream (each frame under fresh
     sensor noise, the map and the last frame carried over), with each
     kernel's launch count over that stream, and one frame under
     torch.profiler (device activities and busy share);
  4. the stream's next frame through the kernels' plain versions, and its
     tracking through the CPU's dense route, each compared with the kernels.
Then the kernel table as one JSON line, the card's name and power limit, and
the device line.  Any failed check exits non-zero.  Needs no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

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


def time_ms(torch, fn, iters: int = 20, own: bool = False):
    """Device time of ``fn`` in ms: its launches captured once in a CUDA graph,
    then the median of ``iters`` replays, each timed by CUDA events.  A plain
    call would time the host's Python between the events as well, which at
    these sizes is longer than the kernels.  With ``own``, returns (that time,
    {kernel: ms per replay}) where the second sums the profiler's device time
    of the port's own kernels over ``iters`` more replays: the wrapper's
    preparation ops and allocations are in the first number only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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
    err = 0.0
    for (s, r), (s0, r0) in zip(got, ref):
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(r, r0, rtol=1e-5, atol=1e-4)
        err = max(err, float((s - s0).abs().max()), float((r - r0).abs().max()))
    px = sum(l.numel() for l in levels)
    b_ms, b_by = bound(px * 12, px * 16 * 6, PEAK_F32)
    rows["fast"] = dict(
        name="fast_detect_levels", source="fishbirdeyevisualslam_torch/csrc/fast.cu",
        replaces="fishbirdeyevisualslam_tpu/ops/pallas_fast.py:125",
        max_abs_err=err, plain_ms=time_ms(torch, lambda: cuda_fast.fast_detect_levels_plain(
            levels, *th)), bound_ms=b_ms, bound_by=b_by, library_ms=None)
    timed(rows["fast"], "fast_detect_levels", lambda: cuda_fast.fast_detect_levels(levels, *th))
    print(f"[kernel] FAST+NMS: {len(levels)} levels, {px} px, max_abs_err {err:.3g}, "
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
    theirs at scripts/bench_matcher.py's shapes, exactly."""
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
    # across the kernel's target tiles and splits
    ties = ((0, (300, 700, nb // 2 + 8)), (1, (5, 6)), (2, (nb - 1, nb // 4 + 1)))
    for q, cols in ties:
        for c in cols:
            db[c], uvb[c] = da[q], uva[q]
    if not torch.equal(cuda_matcher.hamming_matrix_packed(da, db),
                       cuda_matcher.hamming_matrix_packed_plain(da, db)):
        fail("hamming_matrix_packed differs from its plain version")
    n_cand = 0
    for label, valid in (("all valid", vb), ("no valid target", torch.zeros_like(vb))):
        got = cuda_matcher.fused_masked_match(da, uva, db, uvb, valid, radius)
        ref = cuda_matcher.fused_masked_match_plain(da, uva, db, uvb, valid, radius)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            fail(f"fused_masked_match ({label}) differs from its plain version")
        if label == "all valid":
            if got[2][:3].tolist() != [min(c) for _, c in ties] \
                    or got[1][:3].tolist() != [0.0] * 3:
                fail(f"fused_masked_match broke a tie wrongly: {got[2][:3].tolist()}")
            n_cand = int(matcher.window_mask(uva, uvb, radius).sum())
        elif int((got[2] != -1).sum()):
            fail("fused_masked_match matched with no valid target")
    print(f"[kernel] packed Hamming: {na}x{nb}, radius {radius}: matrix exact; masked match "
          f"exact (best, second, idx), ties to the lowest column, no-valid-target case all -1; "
          f"{n_cand} pairs pass the window", flush=True)
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
    # window test on every pair (~6 ops), XOR + popcount + add on the 8 words
    # of each pair that passes, and the running top-2 update (~4 ops)
    ops = na * nb * 6 + n_cand * (8 * 3 + 4)
    nbytes = na * (32 + 8) + nb * (32 + 8 + 1) + na * 12
    b_ms, b_by = bound(nbytes, ops, PEAK_F32)
    rows["masked_match"] = dict(
        name="fused_masked_match", source="fishbirdeyevisualslam_torch/csrc/hamming.cu",
        replaces="fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:130", max_abs_err=0.0,
        plain_ms=time_ms(torch, lambda: cuda_matcher.fused_masked_match_plain(
            da, uva, db, uvb, vb, radius)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    timed(rows["masked_match"], "fused_masked_match",
          lambda: cuda_matcher.fused_masked_match(da, uva, db, uvb, vb, radius))
    print(f"[kernel] fused_masked_match: {rows['masked_match']['ms']:.4f} ms (plain "
          f"{rows['masked_match']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; ops "
          f"{ops}, bytes {nbytes})", flush=True)
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
    if launches["pose_optimization"] != 2 * N_STREAM:
        fail(f"the pose kernel launched {launches['pose_optimization']} times, not 2 per frame")
    if launches["fused_projection_match"] != 3 * N_STREAM:
        fail(f"the single matcher launched {launches['fused_projection_match']} times, not 3 "
             "per frame")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and hold them against their plain versions only")
    ap.add_argument("--profile", action="store_true",
                    help="also print the profiled frame's op table")
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
    rows = phase_kernels(torch, cfg, dev)
    st = Stream(torch, cfg, dev, N_STREAM + N_PHASE + 2)
    rows.update(phase_pose_and_hamming(torch, cfg, dev, st))
    launches = {}
    if not args.kernels_only:
        launches, fps, activities = phase_slice(torch, cfg, dev, st, args.profile)
        print(f"[slice] per frame: {fps:.2f} frames/s, {activities} device activities, "
              f"{launches['pose_optimization'] / N_STREAM:g} pose kernel launches", flush=True)
    by_name = {"fast": "fast_detect_levels", "patch": "extract_patches",
               "match_dual": "fused_projection_match_dual", "match": "fused_projection_match",
               "pose_opt": "pose_optimization", "hamming": "hamming_matrix_packed",
               "masked_match": "fused_masked_match"}
    kernels = []
    for key, fn_name in by_name.items():
        row = dict(rows[key], route="cuda", launches=launches.get(fn_name, 0))
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "kernel_ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")})
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
