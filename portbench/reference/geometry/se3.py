# Frozen copy of fishbirdeyevisualslam_torch/geometry/se3.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""SE(3) / SO(3) Lie-group operations on batched tensors — the port of
``fishbirdeyevisualslam_tpu/geometry/se3.py``.

A pose is one ``(..., 7)`` tensor ``[qw, qx, qy, qz, tx, ty, tz]`` (unit
quaternion, Hamilton convention).  Tangent vectors are ``(omega, upsilon)``
with the left-multiplicative update ``T <- exp(xi) * T`` of g2o's
``VertexSE3Expmap`` (reference ``src/OdomG2oTypeQuat.cc:6-78``).  All
functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

from portbench.reference.device import const


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# quat_mul's 16 products: component c = sum over k of SIGN[c][k] *
# q1[I1[c][k]] * q2[I2[c][k]], summed left to right as the JAX package writes
# it (w1*w2 - x1*x2 - y1*y2 - z1*z2, ...).  Gathered as (4, 4) blocks, one
# product costs a handful of kernels instead of 16 multiplies and 12 adds.
_QM_I1 = ((0, 1, 2, 3), (0, 1, 2, 3), (0, 1, 2, 3), (0, 1, 2, 3))
_QM_I2 = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_QM_SIGN = ((1.0, -1.0, -1.0, -1.0), (1.0, 1.0, 1.0, -1.0), (1.0, -1.0, 1.0, 1.0),
            (1.0, 1.0, -1.0, 1.0))


def quat_mul(q1, q2):
    dev = q1.device
    i1 = const(_QM_I1, torch.long, dev)
    i2 = const(_QM_I2, torch.long, dev)
    p = q1[..., i1] * q2[..., i2] * const(_QM_SIGN, q1.dtype, dev)
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]


def quat_conj(q):
    return q * const((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q; shapes broadcast."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_mul(quat_mul(q, qv), quat_conj(q))[..., 1:]


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def skew(v):
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_quat(omega):
    """Axis-angle -> quaternion (wxyz), with a series near 0."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def so3_log(q):
    """Quaternion (wxyz) -> axis-angle."""
    w0 = q[..., :1]
    q = q * torch.sign(torch.where(w0 == 0, 1.0, w0))
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-18
    vn = torch.sqrt(torch.where(small, 1.0, vn2))
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), theta / vn)
    return scale * v


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3))


def _so3_left_jacobian(omega):
    """V matrix: the exp([w]x) translation coupling, with a series near 0."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-12
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    W = skew(omega)
    W2 = W @ W
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe2 * theta))
    return _eye3(omega) + A[..., None, None] * W + B[..., None, None] * W2


def _so3_left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-12
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    W = skew(omega)
    W2 = W @ W
    half = 0.5 * theta
    cot = half * torch.cos(half) / torch.sin(half)
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot) / safe2)
    return _eye3(omega) - 0.5 * W + k[..., None, None] * W2


def make(q, t):
    return torch.cat([q, t], dim=-1)


def identity(shape=(), dtype=torch.float32, device=None):
    T = const((1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0), dtype, device)
    return T.expand(tuple(shape) + (7,)).clone()


def compose(T1, T2):
    """T1 * T2 (apply T2 first)."""
    q1, t1 = T1[..., :4], T1[..., 4:]
    q2, t2 = T2[..., :4], T2[..., 4:]
    return make(quat_mul(q1, q2), quat_rotate(q1, t2) + t1)


def inverse(T):
    q, t = T[..., :4], T[..., 4:]
    qi = quat_conj(q)
    return make(qi, -quat_rotate(qi, t))


def transform(T, p):
    """Apply pose(s) to point(s): R p + t."""
    return quat_rotate(T[..., :4], p) + T[..., 4:]


def normalize(T):
    return make(quat_normalize(T[..., :4]), T[..., 4:])


def exp(xi):
    """se3 exp, tangent ordered (omega, upsilon) like g2o's update vector."""
    omega, ups = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, ups)
    return make(q, t)


def log(T):
    """se3 log -> (omega, upsilon)."""
    omega = so3_log(T[..., :4])
    Vinv = _so3_left_jacobian_inv(omega)
    ups = torch.einsum("...ij,...j->...i", Vinv, T[..., 4:])
    return torch.cat([omega, ups], dim=-1)


def retract(T, xi):
    """Left-multiplicative update T <- exp(xi) * T (g2o VertexSE3Expmap::oplusImpl)."""
    return normalize(compose(exp(xi), T))


def adjoint(T):
    """6x6 adjoint in (omega, upsilon) ordering: [[R, 0], [[t]x R, R]]."""
    R = quat_to_matrix(T[..., :4])
    tR = skew(T[..., 4:]) @ R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    return torch.cat([top, torch.cat([tR, R], dim=-1)], dim=-2)


def relative_error(T_meas, T1, T2):
    """Pose-graph residual ``log(T_meas^-1 * T1 * T2^-1)`` in (omega, upsilon)
    (``EdgeSE3Quat::computeError``, ``include/OdomG2oTypeQuat.h:176-192``)."""
    return log(compose(inverse(T_meas), compose(T1, inverse(T2))))


def jr_inv_approx(e):
    """The reference's ``EdgeSE3Quat::JRInv`` (``src/OdomG2oTypeQuat.cc:180-190``):
    I + 0.5 [[skew(w), 0], [skew(v), skew(w)]] for e = (omega, upsilon)."""
    Sw = skew(e[..., :3])
    Sv = skew(e[..., 3:])
    top = torch.cat([Sw, torch.zeros_like(Sw)], dim=-1)
    J = torch.cat([top, torch.cat([Sv, Sw], dim=-1)], dim=-2)
    return 0.5 * J + torch.eye(6, dtype=e.dtype, device=e.device).expand(J.shape)


