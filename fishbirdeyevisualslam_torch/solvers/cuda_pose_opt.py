"""Fused per-frame pose optimisation: the wrapper of kernel
``csrc/pose_opt.cu`` and its plain PyTorch version.

Replaces ``fishbirdeyevisualslam_tpu/solvers/pallas_pose_opt.py``'s
``pose_optimization_fused``.  Same inputs and outputs as
``solvers/pose_opt.py:pose_optimization``, which is the plain version: the
wrapper runs it for CPU tensors and launches the kernel (the whole 4 x 10 LM
in one launch, no host read) for CUDA tensors; there is no other fall-back.
``pose_optimization_batched`` solves B problems of one shape in one launch
(a cluster per problem), or the plain LM per row on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fishbirdeyevisualslam_torch import _cuda
from fishbirdeyevisualslam_torch.config import BAConfig, CameraConfig
from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs, PoseOptResult
from fishbirdeyevisualslam_torch.solvers.pose_opt import \
    pose_optimization as pose_optimization_plain


def _check(Tcw0, prior_T, front: FrontObs, bird: BirdObs) -> None:
    """One problem, or a batch: every input with the leading shape of
    ``Tcw0[..., 0]`` (() or (B,)), contiguous, on one CUDA device."""
    dev = Tcw0.device
    lead = tuple(Tcw0.shape[:-1])
    n, nb = front.valid.shape[-1], bird.valid.shape[-1]
    f32, b8 = torch.float32, torch.bool
    for name, t, shape, dtype in (
            ("Tcw0", Tcw0, (7,), f32), ("prior_T", prior_T, (7,), f32),
            ("front.Xw", front.Xw, (n, 3), f32), ("front.uv", front.uv, (n, 2), f32),
            ("front.inv_sigma2", front.inv_sigma2, (n,), f32),
            ("front.valid", front.valid, (n,), b8),
            ("bird.Xw", bird.Xw, (nb, 3), f32), ("bird.Xc", bird.Xc, (nb, 3), f32),
            ("bird.inv_sigma2", bird.inv_sigma2, (nb,), f32),
            ("bird.valid", bird.valid, (nb,), b8)):
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"pose optimisation: {name} must lie on the CUDA device {dev}")
        if t.dtype != dtype or tuple(t.shape) != lead + shape or not t.is_contiguous():
            raise ValueError(f"pose optimisation: {name} must be a contiguous {dtype} tensor "
                             f"of shape {lead + shape}")


def _launch(cam: CameraConfig, ba: BAConfig, Tcw0, front: FrontObs, bird: BirdObs, prior_T,
            prior_info: float) -> PoseOptResult:
    """One launch over one problem (``Tcw0`` (7,)) or a batch (``Tcw0`` (B, 7)):
    one cluster per problem."""
    _check(Tcw0, prior_T, front, bird)
    dev = Tcw0.device
    lead = tuple(Tcw0.shape[:-1])
    n, nb = front.valid.shape[-1], bird.valid.shape[-1]
    T = torch.empty(lead + (7,), dtype=torch.float32, device=dev)
    f_in = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    b_in = torch.empty(lead + (nb,), dtype=torch.bool, device=dev)
    n_in = torch.empty(lead, dtype=torch.int32, device=dev)
    fn = _cuda.load("pose_opt").pose_opt_batched
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci] + [cf] * 12 \
        + [ci, ci] + [vp] * 5
    fn.restype = ci
    delta = float(ba.huber_delta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(math.prod(lead), Tcw0.data_ptr(), prior_T.data_ptr(), front.Xw.data_ptr(),
                 front.uv.data_ptr(), front.inv_sigma2.data_ptr(), front.valid.data_ptr(), n,
                 bird.Xw.data_ptr(), bird.Xc.data_ptr(), bird.inv_sigma2.data_ptr(),
                 bird.valid.data_ptr(), nb, cam.fx, cam.fy, cam.cx, cam.cy, ba.w_front,
                 ba.w_bird, delta, delta ** 2, 2.0 * delta,
                 ba.chi2_mono_pose * (ba.w_front + 1e-9), ba.chi2_bird * (ba.w_bird + 1e-9),
                 float(prior_info), int(ba.pose_rounds), int(ba.pose_iters), T.data_ptr(),
                 f_in.data_ptr(), b_in.data_ptr(), n_in.data_ptr(), stream)
    _cuda.check(err, "pose_opt")
    return PoseOptResult(T, f_in, b_in, n_in)


def pose_optimization(cam: CameraConfig, ba: BAConfig, Tcw0, front: FrontObs, bird: BirdObs,
                      prior_T=None, prior_info: float = 0.0) -> PoseOptResult:
    """4x10 LM with chi2 re-gating plus the optional soft prior, as
    ``pose_optimization_plain``: one kernel launch for CUDA tensors."""
    if prior_T is None:
        prior_T = Tcw0
    if Tcw0.device.type == "cpu":
        return pose_optimization_plain(cam, ba, Tcw0, front, bird, prior_T=prior_T,
                                       prior_info=prior_info)
    out = _launch(cam, ba, Tcw0, front, bird, prior_T, prior_info)
    pose_optimization.launches += 1
    return out


pose_optimization.launches = 0


def pose_optimization_batched_plain(cam: CameraConfig, ba: BAConfig, Tcw0, front: FrontObs,
                                    bird: BirdObs, prior_T=None,
                                    prior_info: float = 0.0) -> PoseOptResult:
    """The plain LM of every row, ``torch.vmap``-ed over the batch (one op per
    step for all rows, where a loop over the rows would run B)."""
    if prior_T is None:
        prior_T = Tcw0

    def one(T, f, b, pT):
        return pose_optimization_plain(cam, ba, T, FrontObs(*f), BirdObs(*b), prior_T=pT,
                                       prior_info=prior_info)

    return PoseOptResult(*torch.vmap(one)(Tcw0, tuple(front), tuple(bird), prior_T))


def pose_optimization_batched(cam: CameraConfig, ba: BAConfig, Tcw0, front: FrontObs,
                              bird: BirdObs, prior_T=None,
                              prior_info: float = 0.0) -> PoseOptResult:
    """B independent problems of one shape: (B, 7) seed poses, (B, N, .) front
    and (B, NB, .) bird observations, (B, 7) priors (default the seeds) and
    one ``prior_info``.  For CUDA tensors one launch of the kernel, a cluster
    per problem; for CPU tensors the plain LM per row."""
    if prior_T is None:
        prior_T = Tcw0
    if Tcw0.device.type == "cpu":
        return pose_optimization_batched_plain(cam, ba, Tcw0, front, bird, prior_T, prior_info)
    if Tcw0.dim() != 2:
        raise ValueError(f"pose_optimization_batched: Tcw0 must be (B, 7), not "
                         f"{tuple(Tcw0.shape)}")
    out = _launch(cam, ba, Tcw0, front, bird, prior_T, prior_info)
    pose_optimization_batched.launches += 1
    return out


pose_optimization_batched.launches = 0


def max_active_clusters() -> int:
    """How many problems of a batch the card runs at once: the kernel's
    resident clusters (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    fn = _cuda.load("pose_opt").pose_opt_max_clusters
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _cuda.check(fn(ctypes.byref(out)), "pose_opt_max_clusters")
    return out.value


def se3_check(T, dx, Tp):
    """The kernel's own SE3 functions on the card, for tests: (n, 7) poses
    ``T``, (n, 6) steps ``dx`` and (n, 7) poses ``Tp`` to ``retract(T, dx)``
    and ``log(T * Tp^-1)``, as ``geometry/se3.py`` computes them."""
    for name, t, w in (("T", T, 7), ("dx", dx, 6), ("Tp", Tp, 7)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != w or not t.is_contiguous() or t.shape[0] != T.shape[0]:
            raise ValueError(f"se3_check: {name} must be a contiguous (n, {w}) float32 CUDA "
                             "tensor")
    n = T.shape[0]
    Tret = torch.empty((n, 7), dtype=torch.float32, device=T.device)
    logrel = torch.empty((n, 6), dtype=torch.float32, device=T.device)
    fn = _cuda.load("pose_opt").se3_check
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_int, vp, vp, vp]
    fn.restype = ctypes.c_int
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = fn(T.data_ptr(), dx.data_ptr(), Tp.data_ptr(), n, Tret.data_ptr(),
                 logrel.data_ptr(), stream)
    _cuda.check(err, "se3_check")
    return Tret, logrel
