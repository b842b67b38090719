"""End-to-end demo on a synthetic sequence: run
``python -m fishbirdeyevisualslam_torch.demo`` (on the CUDA card; ``--cpu``
for the CPU).

Renders a dual-view driving sequence (no dataset required), runs the full
SLAM, prints per-frame timing (the reference's exit stats,
``mono_encoder.cc:202-210``), the ATE against ground truth, and writes
``<prefix>_map.png`` and ``<prefix>_traj.tum`` (``--out-prefix``, default
``demo_torch``), and with ``--draw-every N`` a frame overlay every N frames.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None, render=None) -> dict:
    """Run the demo with command-line arguments ``argv`` (``sys.argv`` by
    default); returns the printed stats.  ``render``, where given, is
    passed to ``synthetic.make_sequence`` (a process pool's renderer, say)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--kind", default="arc",
                    choices=["arc", "straight", "s", "circle", "rect"])
    ap.add_argument("--no-contour", action="store_true",
                    help="skip the contourICP keypoint gating")
    ap.add_argument("--step", type=float, default=0.5)
    ap.add_argument("--odom-noise", type=float, default=0.004)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    # not the JAX demo's "demo": its demo_map.png and demo_traj.tum sit in the repo
    ap.add_argument("--out-prefix", default="demo_torch")
    ap.add_argument("--draw-every", type=int, default=0, metavar="N",
                    help="export a FrameDrawer overlay PNG every N frames "
                         "(<prefix>_frame_<i>.png); 0 = off")
    args = ap.parse_args(argv)

    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.io import synthetic, viz
    from fishbirdeyevisualslam_torch.io.evaluate import ate_rmse_vs_gt
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem

    cfg = SystemConfig()
    print(f"rendering {args.frames}-frame '{args.kind}' sequence ...")
    seq = synthetic.make_sequence(
        cfg, n_frames=args.frames, kind=args.kind, step=args.step,
        odom_noise=args.odom_noise, render=render,
    )
    slam = SlamSystem(cfg, device="cpu" if args.cpu else None)
    drawer = viz.FrameDrawer() if args.draw_every else None
    for i, fr in enumerate(seq.frames):
        contour = None if args.no_contour else fr.get("contour")
        slam.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"],
                   contour=contour)
        if drawer is not None and (i % args.draw_every == 0):
            drawer.update(slam, fr["front"], fr["bird"], contour=contour)
            drawer.save(f"{args.out_prefix}_frame_{i:04d}.png")
        print(f"\rframe {i + 1}/{args.frames} state={slam.state} "
              f"kf={int(slam.map.n_kf) if slam.map is not None else 0}", end="")
    print()
    slam.finish()
    est = slam.frame_trajectory_Twb()
    stats = {
        "ate_rmse_m": round(ate_rmse_vs_gt(est, seq.gt), 4),
        "n_keyframes": int(slam.map.kf_valid.sum()) if slam.map is not None else 0,
        "n_map_points": int(slam.map.mp_valid.sum()) if slam.map is not None else 0,
        "n_bird_points": int(slam.map.bp_valid.sum()) if slam.map is not None else 0,
        "loops_closed": slam.n_loops_closed,
        "timing": slam.timing_stats(),
    }
    print(json.dumps(stats, indent=2))
    with open(f"{args.out_prefix}_traj.tum", "w") as fh:
        fh.write(slam.keyframe_trajectory_tum())
    if slam.map is not None:
        viz.plot_map(slam.map, cfg, f"{args.out_prefix}_map.png",
                     gt_se2=seq.gt, est_Twb=est)
        print(f"wrote {args.out_prefix}_map.png, {args.out_prefix}_traj.tum")
    stats["states"] = [e.state for e in slam.trajectory]
    return stats


if __name__ == "__main__":
    main()
