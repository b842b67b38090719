#!/usr/bin/env python3
"""What the loop correction's solvers cost on a CPU, at the default capacities.

    python3 scripts/cpu_solver_costs.py

The loop corrections that ``chip_smoke.py`` replays on the CPU (phases 7
and 9) spend their time in three places; this script times each on
synthetic inputs of the same shapes (K = 256 keyframe slots, P = 32768 and
PB = 16384 point slots, M = 16, F = 2048), in seconds:

  * ``solvers/ba.py:edge_blocks``, one essential-graph assembly: over all
    K + K^2 + L = 65,793 edges of ``build_pose_graph_edges``, and over 2000;
  * ``bundle_adjust``, one and four LM iterations of the global BA: over
    every point slot (2800 front and 4200 bird points live), and over the
    live points only;
  * ``slam/loop_closing.py:search_and_fuse`` on a map with 26 keyframes and
    3000 points, and ``map_state._obs_slots`` on the loop fusion's batch of
    32768 entries beside the (B, B) rank it replaced.

Needs no JAX and no card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fishbirdeyevisualslam_torch import SystemConfig  # noqa: E402
from fishbirdeyevisualslam_torch.geometry import se3  # noqa: E402
from fishbirdeyevisualslam_torch.slam import loop_closing as lc  # noqa: E402
from fishbirdeyevisualslam_torch.slam import map_state as ms  # noqa: E402
from fishbirdeyevisualslam_torch.slam.frame import desc_pm1_from_packed  # noqa: E402
from fishbirdeyevisualslam_torch.solvers.ba import (  # noqa: E402
    OdomEdges, PointBlocks, bundle_adjust, edge_blocks)


def seconds(fn) -> float:
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def edge_costs(K: int):
    for E in (K + K * K + 1, 2000):
        i, j = (torch.randint(0, 88, (E,), dtype=torch.int32) for _ in range(2))
        Ji, Jj = (torch.randn(E, 6, 6) for _ in range(2))
        r, w = torch.randn(E, 6), torch.rand(E)
        print(f"edge_blocks over {E} edges: {seconds(lambda: edge_blocks(K, i, j, Ji, Jj, r, w)):.3f} s")


def ba_costs(cfg, K: int):
    M = 16
    poses = se3.exp(0.01 * torch.randn(K, 6))
    odom = OdomEdges(torch.arange(K, dtype=torch.int32), torch.arange(K, dtype=torch.int32),
                     poses, torch.ones(K), torch.zeros(K, dtype=torch.bool))
    fixed = torch.arange(K) == 0

    def blocks(P, D, live, compact):
        n = live if compact else P
        pv = torch.arange(n) < live
        return PointBlocks(Xw=torch.randn(n, 3) + torch.tensor([0.0, 0.0, 10.0]),
                           kf_idx=torch.randint(0, 30, (n, M), dtype=torch.int32),
                           meas=torch.randn(n, M, D), inv_sigma2=torch.ones(n, M),
                           valid=(torch.rand(n, M) < 0.2) & pv[:, None], point_valid=pv)

    for compact in (False, True):
        f, b = blocks(cfg.capacity.max_points, 2, 2800, compact), \
            blocks(cfg.capacity.max_bird_points, 3, 4200, compact)
        for it in (1, 4):
            t = seconds(lambda: bundle_adjust(cfg.camera, cfg.ba, poses, fixed, f, b, odom,
                                              n_iters_1=it, n_iters_2=0))
            print(f"bundle_adjust, {'live points only' if compact else 'every point slot'}, "
                  f"{it} iteration(s): {t:.3f} s")


def fuse_costs(cfg):
    m = ms.empty_map(cfg, device="cpu")
    K, P, F = m.K, m.mp_pos.shape[0], m.kf_uv.shape[1]
    kv, mv = torch.arange(K) < 26, torch.arange(P) < 3000
    obs_kf, obs_valid = m.obs_kf.clone(), m.obs_valid.clone()
    for s in range(3):
        obs_kf[:, s] = ((torch.arange(P) + s) % 26).int()
        obs_valid[:, s] = mv
    desc = torch.randint(-2**31, 2**31 - 1, (P, 8), dtype=torch.int32)
    m = m._replace(kf_valid=kv, kf_seq=torch.where(kv, torch.arange(K), -1).int(),
                   kf_Tcw=se3.identity((K,)), mp_valid=mv,
                   mp_pos=torch.randn(P, 3) + torch.tensor([0.0, 0.0, 10.0]), mp_desc=desc,
                   mp_desc_pm1=desc_pm1_from_packed(desc), obs_kf=obs_kf, obs_valid=obs_valid,
                   kf_uv=torch.rand(K, F, 2) * torch.tensor([950.0, 400.0]),
                   kf_desc=torch.randint(-2**31, 2**31 - 1, m.kf_desc.shape, dtype=torch.int32),
                   kf_kp_valid=torch.ones(K, F, dtype=torch.bool))
    print(f"search_and_fuse: {seconds(lambda: lc.search_and_fuse(m, 25, 0, cfg)):.3f} s")
    pid, ok = torch.arange(P, dtype=torch.int32), torch.rand(P) < 0.05

    def square_rank():
        same = (pid[None, :] == pid[:, None]) & ok[None, :] & ok[:, None]
        return torch.sum(torch.tril(same, -1).to(torch.int32), dim=1)

    print(f"_obs_slots over {P} entries: {seconds(lambda: ms._obs_slots(m.obs_valid, pid, ok)):.3f}"
          f" s; the (B, B) rank it replaced: {seconds(square_rank):.3f} s")


def main():
    torch.manual_seed(0)
    cfg = SystemConfig()
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads")
    edge_costs(cfg.capacity.max_keyframes)
    ba_costs(cfg, cfg.capacity.max_keyframes)
    fuse_costs(cfg)


if __name__ == "__main__":
    main()
