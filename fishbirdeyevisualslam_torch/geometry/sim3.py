"""Sim(3) operations for loop closing — the port of
``fishbirdeyevisualslam_tpu/geometry/sim3.py`` (the reference's
``g2o::Sim3``, ``src/Optimizer.cc:1168-1558``).  A similarity is one
``(..., 8)`` tensor ``[qw qx qy qz tx ty tz s]``.
"""

from __future__ import annotations

import torch

from fishbirdeyevisualslam_torch.geometry import se3


def make(q, t, s):
    return torch.cat([q, t, s[..., None] if s.dim() < q.dim() else s], dim=-1)


def from_se3(T):
    """The similarity of pose ``T`` at scale 1."""
    return torch.cat([T, torch.ones_like(T[..., :1])], dim=-1)


def to_se3(S):
    """Drop the scale: t / s, then SE3 (``LoopClosing.cc:544-551``)."""
    return se3.make(S[..., :4], S[..., 4:7] / S[..., 7:])


def scale(S):
    return S[..., 7]


def compose(S1, S2):
    """S1 * S2: R = R1 R2, t = s1 R1 t2 + t1, s = s1 s2."""
    q1, t1, s1 = S1[..., :4], S1[..., 4:7], S1[..., 7:]
    q2, t2, s2 = S2[..., :4], S2[..., 4:7], S2[..., 7:]
    return torch.cat([se3.quat_mul(q1, q2), s1 * se3.quat_rotate(q1, t2) + t1, s1 * s2], dim=-1)


def inverse(S):
    q, t, s = S[..., :4], S[..., 4:7], S[..., 7:]
    qi = se3.quat_conj(q)
    si = 1.0 / s
    return torch.cat([qi, -si * se3.quat_rotate(qi, t), si], dim=-1)


def transform(S, p):
    """Apply: s R p + t."""
    return S[..., 7:] * se3.quat_rotate(S[..., :4], p) + S[..., 4:7]


def log(S):
    """(omega, upsilon, sigma): upsilon through the SE3 V^-1 of t / s."""
    xi = se3.log(to_se3(S))
    return torch.cat([xi, torch.log(S[..., 7:])], dim=-1)


def exp(v):
    T = se3.exp(v[..., :6])
    s = torch.exp(v[..., 6:])
    return torch.cat([T[..., :4], s * T[..., 4:], s], dim=-1)


def retract(S, v):
    return compose(exp(v), S)
