"""Parity of the port's geometry (se3, camera, ipm, odometry) with the JAX
package, on the same numpy inputs, at f32 atol 1e-5 and rtol 1e-5.  The JAX
side of every case is computed once per run (``torch_refs.shared``)."""

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

import torch_refs

torch.set_num_threads(1)

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


SE3_OPS = ["compose", "inverse", "transform", "quat_to_matrix", "retract", "normalize"]
EXP_SCALES = [1e-7, 1e-3, 0.5, 2.5]
IPM_MAPS = ["bird_pixel_to_base_xy", "base_xy_to_bird_pixel"]
IPM_EXTRINSICS = ["base_xyz_to_cam", "cam_xyz_to_base"]


# Each case: the numpy inputs of a test and the JAX package's outputs on them.

def _se3_ops_case(name, seed):
    rng = np.random.RandomState(seed)
    A, B = _poses(rng, 64), _poses(rng, 64)
    p = (rng.randn(64, 3) * 5).astype(np.float32)
    xi = (rng.randn(64, 6) * 0.1).astype(np.float32)
    args = {"compose": (A, B), "inverse": (A,), "transform": (A, p),
            "quat_to_matrix": (A[:, :4],), "retract": (A, xi), "normalize": (A * 1.5,)}[name]
    return args, np.asarray(getattr(j_se3, name)(*map(jnp.asarray, args)))


def _exp_log_case(seed, scale):
    rng = np.random.RandomState(seed)
    xi = (rng.randn(64, 6) * scale).astype(np.float32)
    Tj = np.asarray(j_se3.exp(jnp.asarray(xi)))
    return xi, Tj, np.asarray(j_se3.log(jnp.asarray(Tj)))


def _identity_so3_log_case():
    q = np.array([[-0.9, 0.1, -0.3, 0.2], [0.0, 1.0, 0.0, 0.0]], np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(j_se3.identity((3,))), q, np.asarray(j_se3.so3_log(jnp.asarray(q)))


def _pinhole_case(seed):
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-10, 10, 256), rng.uniform(-5, 5, 256),
                    rng.uniform(-2, 40, 256)], -1).astype(np.float32)
    xyz[:4, 2] = 0.0
    return xyz, np.asarray(j_cam.project_pinhole(JCFG.camera, jnp.asarray(xyz)))


def _undistort_case(seed):
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(0, 950, 512), rng.uniform(0, 400, 512)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [949, 399], [480, 302], [949, 0]]
    return uv, np.asarray(j_cam.undistort_fisheye(JCFG.camera, jnp.asarray(uv)))


def _ipm_map_case(name, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 384, (128, 3)).astype(np.float32)
    return x, np.asarray(getattr(j_ipm, name)(JCFG.bird, jnp.asarray(x)))


def _ipm_extrinsics_case(name, seed):
    rng = np.random.RandomState(seed)
    p = (rng.randn(128, 3) * 4).astype(np.float32)
    return p, np.asarray(getattr(j_ipm, name)(JCFG.extrinsics, jnp.asarray(p)))


def _twb_case(seed):
    A = _poses(np.random.RandomState(seed), 32)
    return A, np.asarray(j_ipm.Twb_from_Twc(JCFG.extrinsics, jnp.asarray(A)))


def _preintegrate_case(seed):
    rng = np.random.RandomState(seed)
    o1 = np.stack([rng.randn(64) * 10, rng.randn(64) * 10, rng.uniform(-3, 3, 64)], -1)
    o2 = o1 + np.stack([rng.randn(64), rng.randn(64), rng.randn(64) * 0.2], -1)
    o1, o2 = o1.astype(np.float32), o2.astype(np.float32)
    return o1, o2, np.asarray(j_odo.preintegrate_base(jnp.asarray(o1), jnp.asarray(o2)))


def _motion_prior_case(seed):
    rng = np.random.RandomState(seed)
    Tprev = _poses(rng, 1, rot=0.3, trans=3.0)[0]
    o1 = np.array([rng.randn() * 5, rng.randn() * 5, rng.uniform(-3, 3)], np.float32)
    o2 = o1 + np.array([0.5, 0.05, 0.02], np.float32)
    return Tprev, o1, o2, np.asarray(j_odo.motion_prior_Tcw(
        JCFG.extrinsics, jnp.asarray(Tprev), jnp.asarray(o1), jnp.asarray(o2)))


def _jax_refs():
    """Every case of this module, keyed by test and parameters."""
    refs = {("identity_so3_log",): _identity_so3_log_case()}
    for seed in SEEDS:
        refs.update({("se3_ops", name, seed): _se3_ops_case(name, seed) for name in SE3_OPS})
        refs.update({("exp_log", seed, scale): _exp_log_case(seed, scale)
                     for scale in EXP_SCALES})
        refs.update({("ipm_map", name, seed): _ipm_map_case(name, seed) for name in IPM_MAPS})
        refs.update({("ipm_extrinsics", name, seed): _ipm_extrinsics_case(name, seed)
                     for name in IPM_EXTRINSICS})
        refs["pinhole", seed] = _pinhole_case(seed)
        refs["undistort", seed] = _undistort_case(seed)
        refs["twb", seed] = _twb_case(seed)
        refs["preintegrate", seed] = _preintegrate_case(seed)
        refs["motion_prior", seed] = _motion_prior_case(seed)
    return refs


torch_refs.register("torch_geometry_jax", __file__, _jax_refs)


@pytest.fixture(scope="module")
def jax_refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_geometry_jax")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SE3_OPS)
def test_se3_ops(jax_refs, name, seed):
    args, out_j = jax_refs["se3_ops", name, seed]
    _close(getattr(t_se3, name)(*map(T, args)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", EXP_SCALES)
def test_se3_exp_log(jax_refs, seed, scale):
    """exp/log agree with the JAX package, including the series branches near 0."""
    xi, Tj, log_j = jax_refs["exp_log", seed, scale]
    _close(t_se3.exp(T(xi)), Tj)
    _close(t_se3.log(T(Tj)), log_j)


def test_se3_identity_and_so3_log_sign(jax_refs):
    ident_j, q, log_j = jax_refs["identity_so3_log",]
    np.testing.assert_array_equal(t_se3.identity((3,)).numpy(), ident_j)
    _close(t_se3.so3_log(T(q)), log_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_project_pinhole(jax_refs, seed):
    xyz, out_j = jax_refs["pinhole", seed]
    _close(t_cam.project_pinhole(CFG.camera, T(xyz)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_undistort_fisheye(jax_refs, seed):
    """Newton undistortion over the whole image, corners (theta clamp) included."""
    uv, out_j = jax_refs["undistort", seed]
    out_t = t_cam.undistort_fisheye(CFG.camera, T(uv)).numpy()
    # pixel sums with cx = 480 carry f32 round-off of ~1 ulp at 500 px (6e-5)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", IPM_MAPS)
def test_ipm_pixel_maps(jax_refs, name, seed):
    x, out_j = jax_refs["ipm_map", name, seed]
    _close(getattr(t_ipm, name)(CFG.bird, T(x)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", IPM_EXTRINSICS)
def test_ipm_extrinsics(jax_refs, name, seed):
    p, out_j = jax_refs["ipm_extrinsics", name, seed]
    _close(getattr(t_ipm, name)(CFG.extrinsics, T(p)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_twb_from_twc(jax_refs, seed):
    A, out_j = jax_refs["twb", seed]
    _close(t_ipm.Twb_from_Twc(CFG.extrinsics, T(A)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_preintegrate_base(jax_refs, seed):
    o1, o2, out_j = jax_refs["preintegrate", seed]
    _close(t_odo.preintegrate_base(T(o1), T(o2)), out_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_motion_prior_Tcw(jax_refs, seed):
    Tprev, o1, o2, out_j = jax_refs["motion_prior", seed]
    _close(t_odo.motion_prior_Tcw(CFG.extrinsics, T(Tprev), T(o1), T(o2)), out_j)
