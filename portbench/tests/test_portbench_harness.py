"""CPU tests of the benchmark's parts: lookup by name, the traffic
generator, the torch renderer against the frozen numpy copy, the drift, the
kernel counts and the no-JAX rule.  Run from the root of the repo:

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, evaluate, render, spec, synth, traffic
from portbench.reference import config as ref_config
from portbench.tests import tiny

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.load_benchmark(ROOT)


def test_benchmark_json_names_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_finds_its_files(cell):
    """Every piece a cell needs is found by its name: config, mix, limits
    and a reader per metric."""
    b = bench()
    w = spec.find_cell(b, cell)
    data = spec.load_config_file(b, w["config"])
    cfg = spec.build_config(ref_config, data["config"])
    assert cfg.flags.have_bird == (w["config"] == "fbev-dual")
    assert dataclasses.asdict(cfg) == data["config"] | {
        g: {k: tuple(v) if isinstance(v, list) else v for k, v in vals.items()}
        for g, vals in data["config"].items()}
    traffic.load_mix(w["traffic"])
    from portbench import judge
    assert judge.load_limits(cell)
    for trace in (False, True):
        for m in spec.metrics_for(b, cell, trace):
            assert callable(spec.reader(m["name"]))


def test_config_must_be_whole():
    data = spec.load_config_file(bench(), "fbev-dual")["config"]
    del data["orb"]["n_levels"]
    with pytest.raises(ValueError, match="n_levels"):
        spec.build_config(ref_config, data)


def test_new_cell_is_files_and_entries(tmp_path):
    """A throwaway configuration, mix and cell, added as new files and new
    BENCHMARK.json entries beside copies of the benchmark's own, are found
    without an edit to any file that was there."""
    root = tiny.make_root(tmp_path)
    b = spec.load_benchmark(root)
    cell = spec.find_cell(b, "tiny-dual.tiny-localize")
    cfg = spec.build_config(ref_config, spec.load_config_file(b, cell["config"], root)["config"])
    assert cfg.capacity.max_points == tiny.TINY_CAPACITY["max_points"]
    assert traffic.load_mix(cell["traffic"], root / "portbench")["route"]["kind"] == "shuttle"
    names = {m["name"] for m in spec.metrics_for(b, cell["name"], True)}
    assert "mapping_host_ms" not in names and "frame_ms_p95" in names
    for f in (HERE / "configs").iterdir():
        assert (root / "portbench" / "configs" / f.name).read_bytes() == f.read_bytes()


def small_mix(name: str) -> dict:
    """A mix cut short, for a drive that renders in seconds on the CPU: a
    mix file of the benchmark's, or the tiny continuing drive."""
    mix = (json.loads(json.dumps(tiny.TINY_MIXES[name])) if name in tiny.TINY_MIXES
           else traffic.load_mix(name))
    mix["path"]["frames"] = 6
    mix["setup_frames"] = min(mix["setup_frames"], 3)
    if mix["route"]["kind"] == "shuttle":
        mix["route"].update(from_m=2.5, to_m=1.5)
    return mix


def small_cfg():
    cfg = ref_config.SystemConfig()
    cam = dataclasses.replace(cfg.camera, width=190, height=80, cx=96.0, cy=60.4, fx=69.7,
                              fy=69.4)
    bird = dataclasses.replace(cfg.bird, rows=96, cols=96)
    return cfg.replace(camera=cam, bird=bird)


@pytest.mark.parametrize("mix", ["localize-slow", "tiny-cruise"])
def test_mix_is_deterministic_in_the_seed(mix):
    m = small_mix(mix)
    cfg = small_cfg()
    cpu = torch.device("cpu")
    a, b = (traffic.make_drive(m, cfg, 2**31 + 17, cpu) for _ in range(2))
    c = traffic.make_drive(m, cfg, 2**31 + 18, cpu)
    assert np.array_equal(a.front, b.front) and np.array_equal(a.bird, b.bird)
    n = 40 if a.shuttle else m["path"]["frames"]
    frames = [a.frame(k) for k in range(n)]
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(frames, (b.frame(k) for k in range(n))))
    # the world is the mix's: another seed drives the same scene with other noise
    assert np.array_equal(a.front, c.front)
    assert not np.array_equal(frames[a.n_setup][2], c.frame(a.n_setup)[2])
    assert traffic.check_sample(m, 5) == traffic.check_sample(m, 5)
    # the path's shape and set-up's odometry do not depend on the seed
    assert all(np.array_equal(x[1], c.frame(k)[1]) for k, x in enumerate(frames))
    assert all(np.array_equal(a.frame(k)[2], c.frame(k)[2]) for k in range(a.n_setup))


def test_shuttle_goes_back_and_forth():
    m = small_mix("localize-slow")
    d = traffic.make_drive(m, small_cfg(), 3, torch.device("cpu"))
    n = len(d.route)
    idx = [d.route_index(j) for j in range(3 * n)]
    assert idx[:n] == list(range(n)) and idx[n:2 * n - 1] == list(range(n - 2, -1, -1))
    steps = np.hypot(*np.diff(d.route[:, :2], axis=0).T)
    assert np.allclose(steps, m["route"]["step_m"], rtol=0.02)
    # each round trip replays one pool of odometry errors, in a seed's order
    e = traffic.make_drive(m, small_cfg(), 4, torch.device("cpu"))
    period = 2 * (n - 1)
    err = lambda drv, k: np.diff(drv.drift[k - 1:k + 1], axis=0)[0]
    for start in (d.n_setup, d.n_setup + period):
        a = sorted(map(tuple, (err(d, k) for k in range(start, start + period))))
        b = sorted(map(tuple, (err(e, k) for k in range(start, start + period))))
        assert np.allclose(a, b)
    assert not np.allclose(d.drift[d.n_setup + 3], e.drift[d.n_setup + 3])


def test_continue_route_ends():
    m = small_mix("tiny-cruise")
    d = traffic.make_drive(m, small_cfg(), 3, torch.device("cpu"))
    assert d.frame(m["path"]["frames"] - 1) is not None
    assert d.frame(m["path"]["frames"]) is None


def test_torch_renderer_holds_to_numpy_copy():
    cfg = small_cfg()
    gt = synth.make_trajectory(4, "arc", step=0.5)
    world = synth.make_world(11, traj=gt)
    front, bird = render.render_frames(world, cfg, gt, torch.device("cpu"))
    for i in range(len(gt)):
        f = np.clip(np.round(synth.render_front(world, cfg, gt[i])), 0, 255)
        b = np.clip(np.round(synth.render_bird(world, cfg, gt[i])), 0, 255)
        df = np.abs(front[i].astype(np.int32) - f)
        db = np.abs(bird[i].astype(np.int32) - b)
        # f32 against numpy's f64 interpolation: a level at a rounding edge
        assert df.max() <= 1 and (df > 0).mean() < 1e-3
        assert db.max() <= 1 and (db > 0).mean() < 1e-3
        assert f.std() > 10


def test_drift_on_a_hand_worked_trajectory():
    # 1 m a frame along x; the estimate 2% long, in another world frame
    gt = np.array([[float(i), 0.0, 0.0] for i in range(11)], np.float32)
    Tw = evaluate.pose7_matrix([np.cos(0.3), 0.0, 0.0, np.sin(0.3), 4.0, -2.0, 1.0])
    est = []
    for i in range(11):
        T = Tw @ evaluate.se2_matrix([1.02 * i, 0.0, 0.0])
        w = np.sqrt(1 + np.trace(T[:3, :3])) / 2
        q = [w, (T[2, 1] - T[1, 2]) / (4 * w), (T[0, 2] - T[2, 0]) / (4 * w),
             (T[1, 0] - T[0, 1]) / (4 * w)]
        est.append(np.concatenate([q, T[:3, 3]]))
    value, n = evaluate.drift_pct(np.asarray(est), gt)
    assert n == 6                      # starts 0..5 reach 5 m at frames 5..10
    assert value == pytest.approx(2.0, rel=1e-6)   # 0.1 m over 5 m
    # a lateral offset of 0.05 m at every frame after the 7th
    gt2 = gt.copy()
    est2 = np.asarray(est).copy()
    est2[:, 4:7] = [[i, 0.05 * (i >= 7), 0.0] for i in range(11)]
    est2[:, :4] = [1, 0, 0, 0]
    value, n = evaluate.drift_pct(est2, gt2)
    assert value == pytest.approx(100 * 0.05 / 5 * 4 / 6)   # starts 2..5 cross it
    assert evaluate.drift_pct(est2[:5], gt2[:5]) == (None, 0)


def test_counts_match_chip_smoke_figures():
    from portbench.reference.ops import image
    cfg = ref_config.SystemConfig()
    levels = (image.build_pyramid(torch.zeros(cfg.camera.height, cfg.camera.width),
                                  cfg.orb.n_levels, cfg.orb.scale_factor)
              + image.build_pyramid(torch.zeros(cfg.bird.rows, cfg.bird.cols),
                                    cfg.orb.n_levels, cfg.orb.scale_factor))
    nbytes, ops, peak = counts.fast_counts(levels)
    assert (nbytes, ops, peak) == (19_594_968, 156_759_744, counts.PEAK_F32)
    nbytes, flops, peak = counts.projection_match_counts(2048, 4096)
    assert flops == 2 * 2048 * 4096 * 256 and peak == counts.PEAK_BF16   # 4.29e+09
    assert nbytes == (2048 + 4096) * 512 + 2048 * 16 + 4096 * 20 + 2048 * 18
    # a 37 x 37 patch per corner, corners far apart: every window pixel read once
    atlas = torch.zeros(200, 400)
    yx = torch.tensor([[0, 0], [0, 100], [100, 200]], dtype=torch.int32)
    nbytes, ops, _ = counts.patch_counts(atlas, yx, 37)
    assert nbytes == 3 * 37 * 37 * 4 + 6 * 4 + 3 * 37 * 37 * 4 and ops == 0
    nbytes, ops, _ = counts.pose_opt_counts(2048, 2048, 1094, 731, 4, 10)
    assert ops == 44 * (1094 + 731) * 200 + 4 * 4096 * 35
    assert nbytes == 2048 * 26 + 2048 * 30 + 84
    assert counts.least_s(3.35e12, 0, counts.PEAK_F32) == pytest.approx(1.0)


def test_run_imports_no_jax():
    """Everything a run imports, the port with it, loads no module whose
    top-level name is jax, jaxlib, flax or fishbirdeyevisualslam_tpu (the
    port's name begins with the JAX package's and must pass)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run as r, portbench.control\n"
        "from portbench import judge, probes, profiling, spec, traffic, evaluate\n"
        "import portbench.reference.slam.tracking, portbench.reference.slam.frame\n"
        "import fishbirdeyevisualslam_torch.slam.system\n"
        "b = spec.load_benchmark()\n"
        "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "assert 'fishbirdeyevisualslam_torch' in sys.modules\n"
        "print(repr(r.forbidden_modules()))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    from portbench import run
    sys.modules["fishbirdeyevisualslam_tpu_x"] = sys.modules["json"]
    try:
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys.modules["json"]
        assert run.forbidden_modules() == ["jax.numpy"]
    finally:
        sys.modules.pop("fishbirdeyevisualslam_tpu_x")
        sys.modules.pop("jax.numpy", None)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dual-localize",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_limits_files_hold_readings():
    for f in (HERE / "limits").iterdir():
        data = json.loads(f.read_text())
        assert set(data) == {"limits", "readings"}
        assert all(v >= 0 for v in data["limits"].values())
