"""The one traffic generator: a mix file of parameters (``traffic/<mix>.json``)
and a seed make a drive, the frames that one camera and its wheel odometry
hand to ``SlamSystem.track`` one after another.

A mix names:

* ``path``: the ground-truth path the world is built along (``kind`` as in
  ``synth.make_trajectory``, ``step_m`` between its poses, ``frames``).
* ``world``: ``seed``, the world's own seed (a fixed world: every run sees
  the same scene, so the seed does not change the work), and
  ``billboards``, how many textured boards stand along the path.
* ``setup_frames``: how many of the path's first poses set-up drives, with
  mapping on (initialization, keyframes, synchronous local mapping).
* ``localize``: where true, set-up then calls ``activate_localization_mode``.
* ``route``: what follows set-up, with no end.  ``{"kind": "continue"}`` goes
  on along the path, pose by pose (a drive that reaches the path's end is
  over, and the run fails).  ``{"kind": "shuttle", "step_m", "from_m",
  "to_m"}`` drives the path resampled by arc length between ``from_m`` and
  ``to_m`` (metres from the path's start) at ``step_m`` a frame, back and
  forth, starting from ``from_m``; one leg is rendered and replayed in
  alternating order.
* ``warmup_frames``: the route's first frames, driven in set-up.
* ``odom_noise``: ``sigma``, the standard deviation of each frame's
  odometry drift step (x and y in metres; the heading's is a tenth of it,
  in radians, as ``synth.odometry_from_gt`` draws it), and ``pool_seed``.
  The drift is the running sum of the steps.  Set-up's steps are drawn from
  ``pool_seed`` alone, so every run maps the same map; the route's steps
  come from one pool of as many steps as the route's period (a shuttle's
  round trip), drawn from ``pool_seed`` too, and each period replays the
  whole pool in an order drawn from ``--seed``: every seed drives the same
  set of odometry errors, in another order, and every pass over a leg has
  other noise.
* ``check_frames``, ``check_span``: the correctness check compares
  ``check_frames`` window frames drawn from the seed among the first
  ``check_span`` (less the first, whose frame before lies in set-up).  Set
  the span to about the frames the slowest host completes in a window: a
  run whose window ends first tracks on past its close, uncounted, to reach
  each drawn frame.

``--seed`` draws the order of the route's odometry errors and the frames
checked.  The path, the world and the set of errors are the mix's, so
every seed drives the same scene at the same speed with the same map:
what a seed changes is the order of the noise, not the work.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from portbench import render, synth

HERE = Path(__file__).resolve().parent
MAX_DRIFT_FRAMES = 1 << 16  # odometry drift steps drawn ahead


def load_mix(name: str, root: Path = HERE) -> dict:
    path = root / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def seed32(seed: int, salt: int = 0) -> int:
    """A 32-bit seed for numpy's RandomState from any whole number."""
    return int(np.random.SeedSequence([int(seed) & ((1 << 128) - 1), salt])
               .generate_state(1)[0])


def resample(gt: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Poses along the path ``gt`` (which starts from the origin at heading 0)
    at arc lengths ``s``: x, y and heading interpolated linearly."""
    pts = np.concatenate([np.zeros((1, 3), np.float64), gt.astype(np.float64)])
    seg = np.hypot(np.diff(pts[:, 0]), np.diff(pts[:, 1]))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    return np.stack([np.interp(s, cum, pts[:, k]) for k in range(3)], axis=-1).astype(np.float32)


@dataclasses.dataclass
class Drive:
    """A drive's frames: ``front``/``bird`` images (uint8, host memory),
    ``mask`` (the freespace mask, the same every frame), and for each frame
    handed to ``track`` in turn its image index, ground truth and
    odometry (``frame(k)``)."""

    mix: dict
    front: np.ndarray
    bird: np.ndarray
    mask: np.ndarray
    gt_setup: np.ndarray      # (S, 3) poses of the set-up's mapped frames
    route: np.ndarray         # (R, 3) poses of the route's rendered frames
    drift: np.ndarray         # (MAX_DRIFT_FRAMES, 3) odometry drift per frame k
    n_setup: int
    shuttle: bool
    fps: float

    def route_index(self, j: int) -> int:
        """The rendered route frame of the route's j-th frame, or -1 past the end."""
        n = len(self.route)
        if not self.shuttle:
            return j if j < n else -1
        period = 2 * (n - 1)
        q = j % period
        return q if q < n else period - q

    def frame(self, k: int):
        """Frame k of the drive: (image index, gt (3,), odometry (3,), timestamp),
        or None where a route without an end has run out."""
        if k < self.n_setup:
            img, gt = k, self.gt_setup[k]
        else:
            r = self.route_index(k - self.n_setup)
            if r < 0:
                return None
            img, gt = self.n_setup + r, self.route[r]
        odom = (gt + self.drift[k % len(self.drift)]).astype(np.float32)
        return img, gt, odom, k / self.fps


def make_drive(mix: dict, cfg, seed: int, device) -> Drive:
    p = mix["path"]
    gt = synth.make_trajectory(p["frames"], p["kind"], step=p["step_m"], seed=0)
    w = mix["world"]
    world = synth.make_world(int(w["seed"]), n_billboards=int(w["billboards"]), traj=gt)
    n_setup = int(mix["setup_frames"])
    route = mix["route"]
    if route["kind"] == "shuttle":
        a, b, step = float(route["from_m"]), float(route["to_m"]), float(route["step_m"])
        n = int(round(abs(b - a) / step)) + 1
        route_poses = resample(gt, a + np.sign(b - a) * step * np.arange(n))
    elif route["kind"] == "continue":
        route_poses = gt[n_setup:]
    else:
        raise ValueError(f"unknown route kind {route['kind']!r}")
    poses = np.concatenate([gt[:n_setup], route_poses])
    front, bird = render.render_frames(world, cfg, poses, device)
    mask, _ = synth.bird_mask_and_contour(cfg, np.zeros((cfg.bird.rows, cfg.bird.cols),
                                                        np.float32))
    noise = mix["odom_noise"]
    pool_rng = np.random.RandomState(int(noise["pool_seed"]))
    period = 2 * (len(route_poses) - 1) if route["kind"] == "shuttle" else len(route_poses)
    setup_steps = pool_rng.randn(n_setup, 3)
    pool = pool_rng.randn(period, 3)
    order = np.random.RandomState(seed32(seed, 1))
    n_periods = -(-(MAX_DRIFT_FRAMES - n_setup) // period)
    route_steps = np.concatenate([pool[order.permutation(period)] for _ in range(n_periods)])
    steps = np.concatenate([setup_steps, route_steps])[:MAX_DRIFT_FRAMES] * float(noise["sigma"])
    drift = np.cumsum(steps, axis=0)
    drift[:, 2] *= 0.1
    return Drive(mix=mix, front=front, bird=bird, mask=mask.astype(np.uint8),
                 gt_setup=gt[:n_setup], route=route_poses, drift=drift, n_setup=n_setup,
                 shuttle=route["kind"] == "shuttle", fps=float(cfg.camera.fps))


def check_sample(mix: dict, seed: int) -> list:
    """The window frames (counted from the window's first) that the
    correctness check compares, drawn from the seed."""
    rng = np.random.RandomState(seed32(seed, 2))
    span, n = int(mix["check_span"]) - 1, int(mix["check_frames"])
    return sorted(1 + int(i) for i in rng.choice(span, size=min(n, span), replace=False))
