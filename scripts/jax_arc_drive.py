"""The JAX package's ``SlamSystem`` over a rendered drive that
``chip_smoke.py`` gives the port (phases 5 and 6: the arc; phase 7: the
rectangle of ``tests/test_loop_closing.py``): per frame, its state, the
motion-model matches, the inliers and the bird inliers, as the smoke prints
them for the port, so that the two facades can be read side by side on one
world; with ``--loop``, loop closing on and each loop candidate tried.

    python scripts/jax_arc_drive.py [--frames 42] [--run 14] [--step 0.5]
    python scripts/jax_arc_drive.py --kind rect --frames 160 --run 160 \
        --step 0.35 --odom-noise 0.02 --loop      # the rectangle's slow test

Renders ``--frames`` frames (the synthetic world depends on the drive's
length) and tracks the first ``--run`` of them at the default
``SystemConfig`` on the CPU.  Prints one line per frame and a JSON line at
the end.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from fishbirdeyevisualslam_tpu import SystemConfig  # noqa: E402
from fishbirdeyevisualslam_tpu.io import synthetic  # noqa: E402
from fishbirdeyevisualslam_tpu.io.evaluate import ate_rmse_vs_gt  # noqa: E402
from fishbirdeyevisualslam_tpu.slam import system  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=42, help="frames rendered")
    ap.add_argument("--run", type=int, default=14, help="frames tracked, from the first")
    ap.add_argument("--step", type=float, default=0.5, help="metres per frame")
    ap.add_argument("--kind", default="arc", help="io/synthetic.py's trajectory kind")
    ap.add_argument("--odom-noise", type=float, default=0.0, help="odometry noise per step")
    ap.add_argument("--loop", action="store_true", help="loop closing on (the default facade)")
    args = ap.parse_args()
    cfg = SystemConfig()
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cfg, n_frames=args.frames, kind=args.kind, step=args.step,
                                  odom_noise=args.odom_noise, seed=0)
    print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    core0, scalars = system.tr.track_frame_core, []

    def core(*a, **k):
        out = core0(*a, **k)
        scalars.append([int(x) for x in np.asarray(out.scalars)])
        return out

    system.tr.track_frame_core = core
    attempts = []
    lc = system.lc
    transform0, verify0, vet0 = (lc.compute_loop_transform, lc.verify_loop_projection,
                                 lc.LoopCloser._odom_consistent)

    def transform(m, cur, cand, cfg_, key):
        S, n_in, ok = transform0(m, cur, cand, cfg_, key)
        attempts.append(dict(kf=int(cur), cand=int(cand), n_inliers=int(n_in), ok=bool(ok),
                             n_proj=None, odom_ok=None))
        return S, n_in, ok

    def verify(m, cur, cand, T, cfg_):
        n = verify0(m, cur, cand, T, cfg_)
        attempts[-1]["n_proj"] = int(n)
        return n

    def vet(self, m, cur, cand, T):
        ok = vet0(self, m, cur, cand, T)
        attempts[-1]["odom_ok"] = bool(ok)
        return ok

    lc.compute_loop_transform, lc.verify_loop_projection = transform, verify
    lc.LoopCloser._odom_consistent = vet
    sys_ = system.SlamSystem(cfg)
    sys_.enable_loop_closing = args.loop
    rows = []
    for i in range(min(args.run, args.frames)):
        fr, n0 = seq.frames[i], len(scalars)
        t1 = time.perf_counter()
        sys_.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"])
        sc = scalars[-1] if len(scalars) > n0 else None
        e = sys_.trajectory[-1]
        row = dict(frame=i, state=int(e.state), keyframe=bool(e.is_keyframe),
                   matches=None if sc is None else sc[0], inliers=None if sc is None else sc[1],
                   bird_inliers=None if sc is None else sc[4])
        rows.append(row)
        print(f"frame {i} ({time.perf_counter() - t1:.1f} s): {row}", flush=True)
    sys_.finish()
    Twb = sys_.frame_trajectory_Twb()
    ate = ate_rmse_vs_gt(Twb, seq.gt[:len(Twb)])
    print(json.dumps(dict(frames=args.frames, run=args.run, step=args.step, kind=args.kind,
                          odom_noise=args.odom_noise, loop=args.loop, ate_m=ate,
                          loops_closed=sys_.n_loops_closed, attempts=attempts,
                          keyframes=len(sys_.keyframe_indices()),
                          states=[r["state"] for r in rows],
                          per_frame=[(r["frame"], r["matches"], r["inliers"], r["bird_inliers"])
                                     for r in rows if r["matches"] is not None])))


if __name__ == "__main__":
    main()
