"""One rank of the port's multi-process landmark-sharded bundle adjustment.

Each process joins a gloo process group of WORLD ranks at
``tcp://localhost:PORT``, builds the same problem, runs
``parallel.sharded_ba.distributed_bundle_adjust`` over a mesh of WORLD
landmark shards and writes its result, with the synchronised wall time of
the solve, to OUT (an ``.npz``).  It imports only torch and the port.

    python scripts/torch_multiprocess_ba_worker.py RANK WORLD PORT OUT \
        [--device cpu|cuda] [--problem example|realistic] [--iters 5 5]

Problems:
  example    ``__graft_entry__._example_problem``'s kind rebuilt in numpy:
             K = 6 keyframes on a line, P = 16 WORLD front and PB = 8 WORLD
             bird landmarks, each seen by M = 3 consecutive keyframes, the
             odometry chain, poses 0.01 off, the first fixed;
  realistic  ``io/fixtures.py:make_realistic_map`` at the default
             ``SystemConfig`` (K = 256, P = 32768, PB = 16384, M = 16)
             through ``map_point_blocks`` and ``odom_chain_edges``, the
             unused and first keyframes fixed, as ``scripts/bench_scaling.py``
             builds it.
With ``--device cuda`` every rank runs on the current card, gloo carrying
the CUDA tensors of the all_reduces; several ranks may share one card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fishbirdeyevisualslam_torch.config import SystemConfig  # noqa: E402
from fishbirdeyevisualslam_torch.geometry import camera, se3  # noqa: E402


def example_problem(K: int = 6, P: int = 32, PB: int = 16, M: int = 3, seed: int = 0):
    """``__graft_entry__._example_problem``'s kind, in numpy: (poses0 (K, 7),
    fixed (K,), front, bird and odometry as dicts of numpy arrays keyed by
    the fields of ``PointBlocks`` and ``OdomEdges``)."""
    cam = SystemConfig().camera
    rng = np.random.RandomState(seed)
    Twc = np.zeros((K, 7), np.float32)
    Twc[:, 0] = 1.0
    Twc[:, 4:] = np.arange(K, dtype=np.float32)[:, None] * np.float32([0.8, -0.01, 0.3])
    poses_true = se3.inverse(torch.from_numpy(Twc))

    def blocks(n: int, dim: int):
        X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n),
                      rng.uniform(10, 25, n)], -1).astype(np.float32)
        kf_idx = (rng.randint(0, K - M, n)[:, None] + np.arange(M)[None, :]).astype(np.int32)
        pc = se3.transform(poses_true[torch.from_numpy(kf_idx).long()],
                           torch.from_numpy(X)[:, None, :])
        meas = (camera.project_pinhole(cam, pc) if dim == 2 else pc).numpy()
        return dict(Xw=X + rng.randn(n, 3).astype(np.float32) * 0.1, kf_idx=kf_idx,
                    meas=meas + rng.randn(n, M, dim).astype(np.float32) * 0.2,
                    inv_sigma2=np.ones((n, M), np.float32), valid=np.ones((n, M), bool),
                    point_valid=np.ones(n, bool))

    front, bird = blocks(P, 2), blocks(PB, 3)
    ii = np.arange(K - 1, dtype=np.int32)
    T_meas = se3.compose(poses_true[:-1], se3.inverse(poses_true[1:])).numpy()
    odom = dict(i=ii, j=ii + 1, T_meas=T_meas, info=np.full(K - 1, 1e4, np.float32),
                valid=np.ones(K - 1, bool))
    xi = 0.01 * rng.randn(K, 6).astype(np.float32)
    xi[0] = 0.0
    poses0 = se3.retract(poses_true, torch.from_numpy(xi)).numpy()
    fixed = np.arange(K) == 0
    return poses0, fixed, front, bird, odom


def tensors(poses0, fixed, front, bird, odom, dev):
    """``example_problem``'s arrays as the port's tensors on ``dev``."""
    from fishbirdeyevisualslam_torch.solvers.ba import OdomEdges, PointBlocks
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(poses0), t(fixed), PointBlocks(**{k: t(v) for k, v in front.items()}),
            PointBlocks(**{k: t(v) for k, v in bird.items()}),
            OdomEdges(**{k: t(v) for k, v in odom.items()}))


def realistic_problem(cfg: SystemConfig, dev):
    """The full-width global BA problem of ``scripts/bench_scaling.py`` on the
    port: (poses0, fixed, front, bird, odom) on ``dev``."""
    from fishbirdeyevisualslam_torch.io.fixtures import make_realistic_map
    from fishbirdeyevisualslam_torch.slam.loop_closing import map_point_blocks
    from fishbirdeyevisualslam_torch.slam.tracking import odom_chain_edges
    m = make_realistic_map(cfg, seed=0, device=dev)
    front, bird = map_point_blocks(m, cfg)
    odom = odom_chain_edges(m, cfg, m.kf_valid)
    fixed = ~m.kf_valid | (torch.arange(m.K, device=dev) == 0)
    return m.kf_Tcw, fixed, front, bird, odom


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--problem", default="example", choices=("example", "realistic"))
    ap.add_argument("--iters", type=int, nargs=2, default=(5, 5))
    args = ap.parse_args()
    from fishbirdeyevisualslam_torch.device import resolve_device
    from fishbirdeyevisualslam_torch.parallel.sharded_ba import (distributed_bundle_adjust,
                                                                make_mesh)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    try:
        cfg = SystemConfig()
        mesh = make_mesh(n_pt=args.world, n_dp=1, device=dev)
        if args.problem == "example":
            n = args.world
            prob = tensors(*example_problem(P=16 * n, PB=8 * n), dev)
        else:
            prob = realistic_problem(cfg, dev)

        def solve():
            out = distributed_bundle_adjust(cfg, mesh, *prob, n_iters_1=args.iters[0],
                                            n_iters_2=args.iters[1])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        runs = 2 if dev.type == "cuda" else 1   # on a card: a warm-up, then the timed run
        for _ in range(runs):
            dist.barrier()
            t0 = time.perf_counter()
            out = solve()
            ms = (time.perf_counter() - t0) * 1e3
        np.savez(args.out, ms=ms, **{k: v.cpu().numpy() for k, v in out._asdict().items()})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
