"""Parity of the port's geometry (se3, camera, ipm, odometry) with the JAX
package, on the same numpy inputs, at f32 atol 1e-5 and rtol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import camera as j_cam
from fishbirdeyevisualslam_tpu.geometry import ipm as j_ipm
from fishbirdeyevisualslam_tpu.geometry import odometry as j_odo
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import camera as t_cam
from fishbirdeyevisualslam_torch.geometry import ipm as t_ipm
from fishbirdeyevisualslam_torch.geometry import odometry as t_odo
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3

torch.set_num_threads(2)

CFG = SystemConfig()
JCFG = JaxConfig()
SEEDS = [0, 1, 2]


def _poses(rng, n, rot=1.0, trans=2.0):
    xi = np.concatenate([rng.randn(n, 3) * rot, rng.randn(n, 3) * trans], -1).astype(np.float32)
    return np.asarray(j_se3.exp(jnp.asarray(xi)))


def _close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["compose", "inverse", "transform", "quat_to_matrix",
                                  "retract", "normalize"])
def test_se3_ops(name, seed):
    rng = np.random.RandomState(seed)
    A, B = _poses(rng, 64), _poses(rng, 64)
    p = (rng.randn(64, 3) * 5).astype(np.float32)
    xi = (rng.randn(64, 6) * 0.1).astype(np.float32)
    args = {"compose": (A, B), "inverse": (A,), "transform": (A, p),
            "quat_to_matrix": (A[:, :4],), "retract": (A, xi), "normalize": (A * 1.5,)}[name]
    out_t = getattr(t_se3, name)(*map(T, args))
    out_j = getattr(j_se3, name)(*map(jnp.asarray, args))
    _close(out_t, out_j)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.5])
def test_se3_exp_log(seed, scale):
    """exp/log agree with the JAX package, including the series branches near 0."""
    rng = np.random.RandomState(seed)
    xi = (rng.randn(64, 6) * scale).astype(np.float32)
    _close(t_se3.exp(T(xi)), j_se3.exp(jnp.asarray(xi)))
    Tj = np.asarray(j_se3.exp(jnp.asarray(xi)))
    _close(t_se3.log(T(Tj)), j_se3.log(jnp.asarray(Tj)))


def test_se3_identity_and_so3_log_sign():
    np.testing.assert_array_equal(t_se3.identity((3,)).numpy(), np.asarray(j_se3.identity((3,))))
    q = np.array([[-0.9, 0.1, -0.3, 0.2], [0.0, 1.0, 0.0, 0.0]], np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _close(t_se3.so3_log(T(q)), j_se3.so3_log(jnp.asarray(q)))


@pytest.mark.parametrize("seed", SEEDS)
def test_project_pinhole(seed):
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-10, 10, 256), rng.uniform(-5, 5, 256),
                    rng.uniform(-2, 40, 256)], -1).astype(np.float32)
    xyz[:4, 2] = 0.0
    _close(t_cam.project_pinhole(CFG.camera, T(xyz)),
           j_cam.project_pinhole(JCFG.camera, jnp.asarray(xyz)))


@pytest.mark.parametrize("seed", SEEDS)
def test_undistort_fisheye(seed):
    """Newton undistortion over the whole image, corners (theta clamp) included."""
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(0, 950, 512), rng.uniform(0, 400, 512)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [949, 399], [480, 302], [949, 0]]
    out_t = t_cam.undistort_fisheye(CFG.camera, T(uv)).numpy()
    out_j = np.asarray(j_cam.undistort_fisheye(JCFG.camera, jnp.asarray(uv)))
    # pixel sums with cx = 480 carry f32 round-off of ~1 ulp at 500 px (6e-5)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["bird_pixel_to_base_xy", "base_xy_to_bird_pixel"])
def test_ipm_pixel_maps(name, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 384, (128, 3)).astype(np.float32)
    cfg_t, cfg_j = CFG.bird, JCFG.bird
    _close(getattr(t_ipm, name)(cfg_t, T(x)), getattr(j_ipm, name)(cfg_j, jnp.asarray(x)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["base_xyz_to_cam", "cam_xyz_to_base"])
def test_ipm_extrinsics(name, seed):
    rng = np.random.RandomState(seed)
    p = (rng.randn(128, 3) * 4).astype(np.float32)
    _close(getattr(t_ipm, name)(CFG.extrinsics, T(p)),
           getattr(j_ipm, name)(JCFG.extrinsics, jnp.asarray(p)))


@pytest.mark.parametrize("seed", SEEDS)
def test_twb_from_twc(seed):
    rng = np.random.RandomState(seed)
    A = _poses(rng, 32)
    _close(t_ipm.Twb_from_Twc(CFG.extrinsics, T(A)),
           j_ipm.Twb_from_Twc(JCFG.extrinsics, jnp.asarray(A)))


@pytest.mark.parametrize("seed", SEEDS)
def test_preintegrate_base(seed):
    rng = np.random.RandomState(seed)
    o1 = np.stack([rng.randn(64) * 10, rng.randn(64) * 10, rng.uniform(-3, 3, 64)], -1)
    o2 = o1 + np.stack([rng.randn(64), rng.randn(64), rng.randn(64) * 0.2], -1)
    o1, o2 = o1.astype(np.float32), o2.astype(np.float32)
    _close(t_odo.preintegrate_base(T(o1), T(o2)),
           j_odo.preintegrate_base(jnp.asarray(o1), jnp.asarray(o2)))


@pytest.mark.parametrize("seed", SEEDS)
def test_motion_prior_Tcw(seed):
    rng = np.random.RandomState(seed)
    Tprev = _poses(rng, 1, rot=0.3, trans=3.0)[0]
    o1 = np.array([rng.randn() * 5, rng.randn() * 5, rng.uniform(-3, 3)], np.float32)
    o2 = o1 + np.array([0.5, 0.05, 0.02], np.float32)
    _close(t_odo.motion_prior_Tcw(CFG.extrinsics, T(Tprev), T(o1), T(o2)),
           j_odo.motion_prior_Tcw(JCFG.extrinsics, jnp.asarray(Tprev), jnp.asarray(o1),
                                  jnp.asarray(o2)))
