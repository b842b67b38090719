"""The JAX package's ``SlamSystem`` over the rendered arc drive that
``chip_smoke.py`` phase 5 gives the port: per tracked frame, its state, the
motion-model matches, the inliers and the bird inliers, as phase 5 prints
them for the port, so that the two facades' tracking can be read side by
side on one world.

    python scripts/jax_arc_drive.py [--frames 42] [--run 14] [--step 0.5]

Renders ``--frames`` frames (the synthetic world depends on the drive's
length) and tracks the first ``--run`` of them at the default
``SystemConfig``, loop closing off, on the CPU.  Prints one line per frame
and a JSON line at the end.
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
    args = ap.parse_args()
    cfg = SystemConfig()
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cfg, n_frames=args.frames, kind="arc", step=args.step, seed=0)
    print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    core0, scalars = system.tr.track_frame_core, []

    def core(*a, **k):
        out = core0(*a, **k)
        scalars.append([int(x) for x in np.asarray(out.scalars)])
        return out

    system.tr.track_frame_core = core
    sys_ = system.SlamSystem(cfg)
    sys_.enable_loop_closing = False
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
    Twb = sys_.frame_trajectory_Twb()
    ate = ate_rmse_vs_gt(Twb, seq.gt[:len(Twb)])
    print(json.dumps(dict(frames=args.frames, run=args.run, step=args.step, ate_m=ate,
                          states=[r["state"] for r in rows],
                          per_frame=[(r["frame"], r["matches"], r["inliers"], r["bird_inliers"])
                                     for r in rows if r["matches"] is not None])))


if __name__ == "__main__":
    main()
