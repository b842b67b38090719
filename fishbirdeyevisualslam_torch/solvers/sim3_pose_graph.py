"""Sim(3) pose-graph optimisation, the scale-drift-aware essential graph —
the port of ``fishbirdeyevisualslam_tpu/solvers/sim3_pose_graph.py`` (the
``bFixScale = false`` branch of ``Optimizer::OptimizeEssentialGraph``,
``src/Optimizer.cc:1168-1558``): vertices are Sim3 world-to-camera
transforms (7 dof: rotation, translation, log scale), edges constrain
relative Sim3 poses, and the solver is Levenberg-Marquardt on the product
manifold, as in the JAX package.

The JAX package forms the dense Jacobian of every edge against all 7K
tangents by forward-mode autodiff (at K = 256 and the K + K^2 + L edges of
``build_pose_graph_edges``, 460,551 x 1792 f32 in 1792 forward passes).
Here each valid edge's residual is differentiated against its own 14
tangents only (``torch.func.jacrev``, vmapped over the edges: 7 reverse
passes per edge; forward mode through the geometry's ``torch.where`` with a
Python number promotes the tangents to f64 in this torch), and H = J^T W J
and g = J^T W r are assembled from the 7 x 14 blocks by ``ba.edge_blocks``,
as the SE3 pose graph's are, so the system is the same bit for bit from run
to run on the card.  Fixed vertices are pinned and the system damped as the
JAX package does; the ``SIM3_ITERS`` iterations make no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fishbirdeyevisualslam_torch.geometry import sim3
from fishbirdeyevisualslam_torch.solvers.ba import edge_blocks

SIM3_ITERS = 20        # LM iterations of the Sim3 essential graph
SIM3_LAMBDA0 = 1e-6    # LM's initial damping


class Sim3Edges(NamedTuple):
    i: torch.Tensor        # (E,) int32 first vertex
    j: torch.Tensor        # (E,) int32 second vertex
    S_meas: torch.Tensor   # (E, 8) measured S_i * S_j^-1
    info: torch.Tensor     # (E,) scalar information weight
    valid: torch.Tensor    # (E,) bool


def edge_residuals(S, edges: Sim3Edges):
    """(E, 7) tangent residuals log(S_meas^-1 * S_i * S_j^-1) (g2o's
    ``EdgeSim3``), unweighted."""
    return _residual(S[edges.i.long()], S[edges.j.long()], edges.S_meas)


def _residual(Si, Sj, S_meas):
    return sim3.log(sim3.compose(sim3.inverse(S_meas), sim3.compose(Si, sim3.inverse(Sj))))


def _edge_jacobians(Si, Sj, S_meas):
    """(E, 7, 14): each residual against the tangents (delta_i, delta_j) of its
    two vertices at zero, vertices updated as S <- exp(delta) S."""
    def f(d, si, sj, sm):
        return _residual(sim3.retract(si, d[:7]), sim3.retract(sj, d[7:]), sm)

    zero = Si.new_zeros(Si.shape[0], 14)
    return torch.func.vmap(torch.func.jacrev(f))(zero, Si, Sj, S_meas)


def normal_equations(S, fixed, i, j, S_meas, w):
    """H (7K, 7K) = J^T W J and g (7K,) = J^T W r of the residuals r =
    log(...) over the edges given (valid ones only) with weights ``w``, the
    fixed vertices' tangents held at zero (their columns of J are zero, as
    in the JAX package's ``delta * free``).  Returns (H, g, r (E, 7))."""
    K = S.shape[0]
    free = (~fixed).to(S.dtype)
    Si, Sj = S[i.long()], S[j.long()]
    r = _residual(Si, Sj, S_meas)
    J = _edge_jacobians(Si, Sj, S_meas)
    Ji = J[..., :7] * free[i.long()][:, None, None]
    Jj = J[..., 7:] * free[j.long()][:, None, None]
    H, g = edge_blocks(K, i, j, Ji, Jj, r, w)
    return H.reshape(7 * K, 7 * K), g.reshape(7 * K), r


def optimize_sim3_pose_graph(S0, fixed, edges: Sim3Edges):
    """LM over the product Sim3 manifold, ``SIM3_ITERS`` iterations; returns
    the optimised (K, 8).  Fixed vertices (the loop keyframe,
    ``Optimizer.cc:1217``) contribute residuals but take no update: their
    rows and columns are pinned by 1e12 on the diagonal, as g2o's
    ``setFixed``.  The valid edges are picked once (one host read)."""
    K = S0.shape[0]
    sel = torch.nonzero(edges.valid).reshape(-1)
    i, j, S_meas = edges.i[sel], edges.j[sel], edges.S_meas[sel]
    w = edges.info[sel].to(S0.dtype)
    free = (~fixed).to(S0.dtype)
    pin = torch.where(fixed, 1e12, 0.0).to(S0.dtype).repeat_interleave(7)
    S = S0
    lam = torch.full((), SIM3_LAMBDA0, dtype=S0.dtype, device=S0.device)
    cost = lambda r: torch.sum(w * torch.sum(r * r, dim=-1))
    for _ in range(SIM3_ITERS):
        H, g, r0 = normal_equations(S, fixed, i, j, S_meas, w)
        Hd = H + torch.diag(lam * (torch.diagonal(H) + 1e-9) + pin)
        dx = -torch.linalg.solve(Hd, g)
        S_new = sim3.retract(S, dx.reshape(K, 7) * free[:, None])
        accept = cost(_residual(S_new[i.long()], S_new[j.long()], S_meas)) < cost(r0)
        S = torch.where(accept, S_new, S)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return S


def carry_points_sim3(points, ref_kf, S_old, S_new):
    """Landmarks moved with their reference keyframe's Sim3 correction:
    X_new = S_new^-1 * S_old * X_old, with scale (``Optimizer.cc:1515-1556``,
    ``LoopClosing.cc:506-525``)."""
    r = ref_kf.long()
    corr = sim3.compose(sim3.inverse(S_new[r]), S_old[r])
    return sim3.transform(corr, points)
