"""A throwaway cell for the CPU tests: a reduced capacity and a short drive,
added as new files and new BENCHMARK.json entries beside a copy of the
benchmark's own, as a later change would add a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

TINY_CAPACITY = dict(max_keyframes=32, max_points=4096, max_bird_points=2048,
                     max_front_kp=1024, max_bird_kp=1024, max_local_kfs=16,
                     max_local_observers=16, max_local_points=2048,
                     max_local_bird_points=2048)
# the mapping step's limits, from the TF32 control of the 0.5 m arc drive
# (PERF.md: the cruise cell that waits for a fix of the program)
MAPPING_LIMITS = {"map_kf_gap_mm": 0.1, "map_point_gap_mm": 1.0, "map_point_mismatch": 0.002}
TINY_MIXES = {
    "tiny-localize": {
        "why": "a short localization shuttle for the CPU tests",
        "path": {"kind": "arc", "step_m": 0.5, "frames": 5},
        "world": {"seed": 0, "billboards": 24}, "setup_frames": 5,
        "localize": True, "route": {"kind": "shuttle", "step_m": 0.25, "from_m": 2.4,
                                    "to_m": 1.4},
        "warmup_frames": 1, "odom_noise": {"sigma": 0.004, "pool_seed": 0},
        "check_frames": 2, "check_span": 3,
        "trace_from": 0, "trace_frames": 1},
    "tiny-cruise": {
        "why": "a short mapping drive for the CPU tests",
        "path": {"kind": "arc", "step_m": 0.5, "frames": 12},
        "world": {"seed": 0, "billboards": 24}, "setup_frames": 4,
        "localize": False, "route": {"kind": "continue"}, "warmup_frames": 0,
        "odom_noise": {"sigma": 0.004, "pool_seed": 0}, "check_frames": 1, "check_span": 2,
        "trace_from": 0, "trace_frames": 1},
}


def make_root(tmp: Path, n_features_init: int = 2048) -> Path:
    """A checkout-like directory: BENCHMARK.json with the tiny cells added,
    and portbench/ data files copied, with the tiny configuration, mixes and
    limits added as files of their own."""
    root = Path(tmp)
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / sub, pb / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "fbev-dual.json").read_text())
    cfg["name"] = "tiny-dual"
    cfg["config"]["capacity"].update(TINY_CAPACITY)
    cfg["config"]["orb"]["n_features_init"] = n_features_init
    (pb / "configs" / "tiny-dual.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-dual", "source": cfg["source"],
                             "file": "portbench/configs/tiny-dual.json",
                             "reduced": ["capacity"], "why": "CPU tests"})
    for mix, body in TINY_MIXES.items():
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(body))
        cell = f"tiny-dual.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny-dual", "traffic": mix,
                                   "chips": 1, "why": "CPU tests"})
        limits = json.loads((HERE / "limits" / "dual-localize.json").read_text())
        if "cruise" in mix:
            limits["limits"].update(MAPPING_LIMITS)
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    # a per-layer metric added as an entry: its reader is metrics/mapping_host_ms.py
    bench["per_layer"].append({
        "name": "mapping_host_ms", "unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "local mapping", "moves": "fps", "workloads": ["tiny-dual.tiny-cruise"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
