"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``).  A run:

1. sets up: renders the drive on the card from ``--seed``, builds
   ``SlamSystem(cfg, device="cuda")`` and drives the mix's set-up frames
   (initialization and mapping, then localization mode where the mix asks
   for it, then the warm-up frames), which builds and loads every kernel;
2. hands ``SlamSystem.track`` the drive's next frame as soon as the last
   call returned (a closed loop, one camera) for ``--seconds``;
3. synchronises the card, reads the peak memory and the trajectory, and
   where the window closed before a frame the check drew, tracks on,
   uncounted, until it is reached;
4. frees the port's state and decides ``correct`` (``judge.py``);
5. prints the checks on standard error and the result as the last line of
   standard output.

With ``--trace 1`` the run reports the per-layer metrics instead of the
end-to-end ones: host spans around the core and the mapping step, host
syncs per frame, and a ``torch.profiler`` trace over a fixed slice of the
window (the mix's ``trace_from``, ``trace_frames``).  Each metric is read by
``metrics/<name>.py``.  Without a CUDA card the run exits with 2 and prints
no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "fishbirdeyevisualslam_tpu")


def process_start() -> float:
    """The epoch second at which this process started (from /proc, to the
    clock tick), or the time this module was imported where /proc is not."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _outside(w0: dict, s0: dict, s1: dict, w1: dict, name: str) -> tuple:
    """(count, total s) of a Tracer span over the window, less the profiled
    slice: the reports at the window's start, the slice's start and end, and
    the window's end."""
    get = lambda rep, key: rep.get(name, {}).get(key, 0)
    return tuple(get(w1, key) - get(s1, key) + get(s0, key) - get(w0, key)
                 for key in ("count", "total_s"))


def _sixths(lat: list) -> list:
    """The median frame ms of each sixth of the window: how far the host's
    pace moved during the run."""
    n = max(1, len(lat) // 6)
    return [round(statistics.median(lat[i:i + n]) * 1e3, 2) for i in range(0, n * 6, n)
            if lat[i:i + n]]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, root: Path = ROOT, control: bool = False,
             on_window=None) -> dict:
    """One run of ``workload`` on ``device``; returns the result line's
    object.  The caller checks for a card first; tests call this with a CPU
    device and a BENCHMARK.json of their own under ``root``.  With
    ``control``, the result also holds the control's numbers (the reference
    with TF32 products in the port's place) under ``control``.  ``on_window``,
    where given, is called as the window opens (the fault tests plant their
    faults there)."""
    import numpy as np
    import torch

    from fishbirdeyevisualslam_torch import config as port_config
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    from portbench import judge, probes, profiling, spec, traffic
    from portbench.reference import config as ref_config

    t_start = process_start() if t_start is None else t_start
    here = root / "portbench"
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    cfile = spec.load_config_file(bench, cell["config"], root)
    cfg = spec.build_config(port_config, cfile["config"])
    rcfg = spec.build_config(ref_config, cfile["config"])
    mix = traffic.load_mix(cell["traffic"], here)
    limits = judge.load_limits(workload, here)
    metrics = spec.metrics_for(bench, workload, trace)
    readers = {m["name"]: spec.reader(m["name"], here) for m in metrics}
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    drive = traffic.make_drive(mix, cfg, seed, device)
    check = traffic.check_sample(mix, seed)
    sys_ = SlamSystem(cfg, device=device)
    pr = probes.Probes(check, trace).install()
    dtrace = profiling.DeviceTrace(device) if trace else None
    trace_from, trace_to = int(mix["trace_from"]), int(mix["trace_from"]) + int(mix["trace_frames"])
    inputs, returned = {}, {}
    try:
        def track(k):
            fr = drive.frame(k)
            if fr is None:
                raise RuntimeError(f"the drive ran out of frames at frame {k}: render more")
            img, _, odom, ts = fr
            return fr, sys_.track(drive.front[img], drive.bird[img], drive.mask, odom, ts)

        k = 0
        for k in range(drive.n_setup):
            track(k)
        k = drive.n_setup
        if mix.get("localize"):
            sys_.activate_localization_mode()
        for _ in range(int(mix["warmup_frames"])):
            track(k)
            k += 1
        setup_state = sys_.state
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.time() - t_start
        w0 = k
        spans0 = sys_.tracer.report()
        if on_window is not None:
            on_window()
        slice0 = slice1 = spans0
        lat, syncs, ok, traced, routes = [], [], [], [], []

        def keep(j, fr, T):
            if j in pr.check or j in pr.prior:
                inputs[j], returned[j] = fr, T
                pr.mark(j, sys_.last_route == "core" and sys_.state == tr.OK
                        and not sys_.trajectory[-1].is_keyframe)
        cpu0 = probes.cpu_reading()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            j = k - w0
            if dtrace is not None and j == trace_from:
                slice0 = sys_.tracer.report()
                dtrace.start()
                pr.recording = True
            if dtrace is not None and j == trace_to:
                pr.recording = False
                dtrace.stop()
                slice1 = sys_.tracer.report()
            counted = []
            pr.frame = j
            with probes.count_syncs(counted) if trace and cuda else contextlib.nullcontext():
                ta = time.perf_counter()
                fr, T = track(k)
                lat.append(time.perf_counter() - ta)
            pr.frame = None
            syncs.append(counted[0] if counted else 0)
            traced.append(trace_from <= j < trace_to)
            ok.append(sys_.state == tr.OK)
            routes.append(sys_.last_route)
            keep(j, fr, T)
            k += 1
        if dtrace is not None and dtrace.prof is not None and pr.recording:
            pr.recording = False
            dtrace.stop()
            slice1 = sys_.tracer.report()
        sync()
        window_s = time.perf_counter() - t0
        cpu_share = probes.cpu_reading(cpu0, window_s)
        n = len(lat)
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        spans1 = sys_.tracer.report()
        # the check's frames past the window's close: tracked, not counted
        while k - w0 <= max(pr.check, default=-1):
            pr.frame = k - w0
            fr, T = track(k)
            pr.frame = None
            keep(k - w0, fr, T)
            k += 1
    finally:
        pr.remove()
    traj = sys_.frame_trajectory_Twb()
    if len(traj) != k:
        raise RuntimeError(f"the trajectory holds {len(traj)} frames of {k}")
    run = types.SimpleNamespace(
        workload=workload, seed=seed, cfg=cfg, mix=mix, setup_s=setup_s, window_s=window_s,
        n_frames=n, latencies_s=lat, traced=traced, syncs=syncs, failed=n - sum(ok),
        est_Twb=traj[w0:w0 + n], gt=np.stack([drive.frame(i)[1] for i in range(w0, w0 + n)]),
        tracer={name: _outside(spans0, slice0, slice1, spans1, name) for name in spans1},
        spans={name: tuple(v) for name, v in pr.spans.items()},
        n_loops_closed=sys_.n_loops_closed, profile=None, least_s=None)
    if dtrace is not None and dtrace.t1 > 0:
        from fishbirdeyevisualslam_torch import _cuda
        run.profile = dtrace.reduce(profiling.own_kernel_names(_cuda.CSRC))
        run.least_s = pr.launch_least_s()
    caps = pr.captures
    for j, cap in caps.items():
        cap["input"], cap["returned"] = inputs[j], returned[j]
    del sys_, pr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    prog = judge.program_outputs(caps)
    ref = judge.reference_outputs(caps, drive, rcfg, device)
    per_frame, ctrl_frames = {}, {}
    numbers = judge.compare(prog, ref, per_frame)
    correct, rows = judge.decide(numbers, limits)
    ctrl = None
    if control:
        ctrl = judge.compare(judge.reference_outputs(caps, drive, rcfg, device, tf32=True), ref,
                             ctrl_frames)
    judge_s = time.perf_counter() - t_judge

    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": n, "failed": run.failed, "metrics": values,
           "device": dev}
    if run.profile is not None:
        p = run.profile
        dev["busy_s"], dev["window_s"] = p["busy_s"], p["window_s"]
        out["breakdown"] = {"device_ops": [[a, b] for a, b in p["device_ops"]],
                            "idle_gaps": [[a, b] for a, b in p["idle_by_span"]]}
    out["info"] = {"frames_checked": sorted(j for j, c in caps.items() if c.get("checked")),
                   "judge_s": judge_s,
                   "loops_closed": run.n_loops_closed, "setup_frames": w0,
                   "setup_state": int(setup_state),
                   "routes": {r: routes.count(r) for r in set(routes)},
                   "frame_ms_median_by_sixth": _sixths(lat), "process_cpu_share": cpu_share,
                   "core_by_frame": per_frame}
    if ctrl is not None:
        out["control"] = ctrl
        out["info"]["control_core_by_frame"] = ctrl_frames
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from portbench import spec
    # one host thread for PyTorch's CPU ops: the port's host work is Python
    # dispatch, and a pool of spinning intra-op threads only adds jitter
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("no CUDA device is available: the benchmark runs only on the card")
        return 2
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell asks for {cell['chips']} cards; {torch.cuda.device_count()} present")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
