"""Pose-graph (essential-graph) optimisation for loop closing — the port of
``fishbirdeyevisualslam_tpu/solvers/pose_graph.py`` (the reference's
``Optimizer::OptimizeEssentialGraph``, ``src/Optimizer.cc:1168-1558``, in the
fixed-scale regime it runs): spanning-tree edges, every strong covisibility
edge (>= min_feat shared points), the bird-covisibility fallback for
keyframes without a strong front edge, and the loop edges.

It is a relative-pose factor graph: one ``bundle_adjust`` with empty point
blocks.  Landmarks then move rigidly with their reference keyframe's
correction (``Optimizer.cc:1515-1556``).
"""

from __future__ import annotations

import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.solvers.ba import EDGE_CHUNK, OdomEdges, PointBlocks, bundle_adjust

POSE_GRAPH_ITERS = 20   # LM iterations of the essential graph


def _empty_blocks(dim: int, device) -> PointBlocks:
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)
    return PointBlocks(Xw=z(1, 3), kf_idx=z(1, 1, dtype=torch.int32), meas=z(1, 1, dim),
                       inv_sigma2=torch.ones((1, 1), device=device),
                       valid=z(1, 1, dtype=torch.bool), point_valid=z(1, dtype=torch.bool))


def optimize_pose_graph(cfg: SystemConfig, poses, fixed, edges: OdomEdges):
    """SE3 pose-graph LM over ``POSE_GRAPH_ITERS`` iterations; ``edges.T_meas``
    are the relative poses measured when the edges were made.  The one-hot
    products of the (i, j) blocks skip the chunks of edges without a valid
    one (one host read finds them: the K^2 pairs of ``build_pose_graph_edges``
    are valid only in the rows of live keyframes), which changes no bit."""
    dev = poses.device
    E = edges.valid.shape[0]
    pad = torch.zeros(-E % EDGE_CHUNK, dtype=torch.bool, device=dev)
    live = torch.cat([edges.valid, pad]).reshape(-1, EDGE_CHUNK).any(dim=1).tolist()
    chunks = [k * EDGE_CHUNK for k, x in enumerate(live) if x]
    out = bundle_adjust(cfg.camera, cfg.ba, poses, fixed, _empty_blocks(2, dev),
                        _empty_blocks(3, dev), edges, n_iters_1=POSE_GRAPH_ITERS, n_iters_2=0,
                        odom_chunks=chunks)
    return out.poses


def carry_points(points, ref_kf, poses_old, poses_new):
    """Landmarks moved with their reference keyframe's correction:
    X_new = Twc_new * Tcw_old * X_old per point."""
    r = ref_kf.long()
    corr = se3.compose(se3.inverse(poses_new[r]), poses_old[r])
    return se3.transform(corr, points)


def _first_argmax(x):
    """Row-wise index of the first maximum (``jnp.argmax``'s tie order)."""
    return torch.argmax(x, dim=1).to(torch.int32)


def build_pose_graph_edges(cfg: SystemConfig, poses_meas, covis, bird_covis, kf_valid, kf_seq,
                           loop_i, loop_j, loop_T) -> OdomEdges:
    """The essential graph's edges: the covisibility spanning tree (parent =
    the older keyframe, by insertion sequence ``kf_seq``, with the most
    shared front points, else bird points, else the nearest older one),
    every pair with >= min_feat (``cfg.ba.essential_graph_min_feat``) shared
    front points, bird pairs (>= 2) of keyframes without such a pair, and
    the loop edges (L,).  K + K^2 + L edges, the dense pairs in row-major
    order.  Information: 100 on the tree, 100 x clip(shared / min_feat, 1,
    4) on the pairs, 400 on loop edges."""
    K = poses_meas.shape[0]
    dev = poses_meas.device
    min_feat = cfg.ba.essential_graph_min_feat
    idx = torch.arange(K, dtype=torch.int32, device=dev)
    valid2 = kf_valid[None, :] & kf_valid[:, None]
    earlier = (kf_seq[None, :] < kf_seq[:, None]) & valid2
    wf = torch.where(earlier, covis, -1)
    wb = torch.where(earlier, bird_covis, -1)
    p_near = _first_argmax(torch.where(earlier, kf_seq[None, :], -1))
    parent = torch.where(wf.max(dim=1).values > 0, _first_argmax(wf),
                         torch.where(wb.max(dim=1).values > 0, _first_argmax(wb), p_near))
    cvalid = kf_valid & kf_valid[parent.long()] & earlier.any(dim=1) & (idx != parent)

    strong = (covis >= min_feat) & valid2
    bird_edge = (bird_covis >= 2) & ~strong.any(dim=1)[:, None] & valid2
    adj = torch.triu(strong | bird_edge, 1)
    ei = idx.repeat_interleave(K)
    ej = idx.repeat(K)
    cw = (covis + bird_covis).reshape(-1).to(torch.float32)
    einfo = 100.0 * torch.clamp(cw / float(min_feat), 1.0, 4.0)

    all_i = torch.cat([idx, ei, loop_i.to(torch.int32)])
    all_j = torch.cat([parent, ej, loop_j.to(torch.int32)])
    L = loop_i.shape[0]
    all_valid = torch.cat([cvalid, adj.reshape(-1), torch.ones(L, dtype=torch.bool, device=dev)])
    n = all_i.shape[0] - L
    T_rel = se3.compose(poses_meas[all_i[:n].long()], se3.inverse(poses_meas[all_j[:n].long()]))
    T_rel = torch.cat([T_rel, loop_T.to(T_rel.dtype)])
    info = torch.cat([torch.full((K,), 100.0, device=dev), einfo,
                      torch.full((L,), 400.0, device=dev)])
    return OdomEdges(all_i, all_j, T_rel, info, all_valid)
