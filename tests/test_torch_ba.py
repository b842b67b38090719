"""Parity of the port's solver additions with the JAX package on the CPU:
the SE3 adjoint / relative error / JRInv, the BA residuals and point
Jacobians (f32, within 1e-4 relative), the QR + SVD null vectors and 3x3
solves (within 1e-4), triangulation (the same acceptance on >= 99% of rows,
world points within 1e-3 m where both accept), and ``bundle_adjust`` on
``tests/test_ba.py``'s kind of problem (a fixed keyframe, odometry edges, ten front
outliers): poses within 2e-4 of the se3 log, points within 5e-3 m, the
inlier classification equal.  Those two bounds are the spread of f32 on this
problem: the port in f64 and in f32 differ by 1.05e-4 and 3.3e-3 m after the
15 iterations (depth along the rays is the weak direction), the port and JAX
in f32 by 8.6e-5 and 2.7e-3 m.  The reduced solve's LU branch is held on an
indefinite system whose Cholesky fails.  JAX runs once per test run
(``torch_refs.shared``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.solvers import ba as j_ba
from fishbirdeyevisualslam_tpu.solvers import linalg as j_linalg
from fishbirdeyevisualslam_tpu.solvers import residuals as j_res
from fishbirdeyevisualslam_tpu.solvers import triangulate as j_tri
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.solvers import ba as t_ba
from fishbirdeyevisualslam_torch.solvers import linalg as t_linalg
from fishbirdeyevisualslam_torch.solvers import residuals as t_res
from fishbirdeyevisualslam_torch.solvers import triangulate as t_tri

import torch_refs
from torch_scenes import _project_np, ba_problem

torch.set_num_threads(1)

CFG = SystemConfig()
JCFG = JaxConfig()
CAM = CFG.camera


def _poses(rng, n, rot=0.3, trans=2.0):
    q = np.concatenate([np.ones((n, 1)), rng.randn(n, 3) * rot / 2], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, rng.randn(n, 3) * trans], -1).astype(np.float32)


def _inputs():
    """Every input of this module but the BA problem, made with numpy from a seed."""
    rng = np.random.RandomState(0)
    T1, T2, Tm = _poses(rng, 64), _poses(rng, 64), _poses(rng, 64)
    X = np.stack([rng.uniform(-5, 5, 64), rng.uniform(-3, 3, 64), rng.uniform(4, 20, 64)],
                 -1).astype(np.float32)
    uv = rng.uniform(0, 900, (64, 2)).astype(np.float32)
    A = rng.randn(64, 8, 9).astype(np.float32)
    A4 = rng.randn(64, 4, 4).astype(np.float32)
    S = rng.randn(64, 3, 3).astype(np.float32)
    S = S @ S.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    b3 = rng.randn(64, 3).astype(np.float32)
    # two views of 400 points, 0.5 px noise, 10% of the second view's pixels off
    Tc1 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    Tc2 = np.array([0.9999, 0.005, -0.015, 0.0025, -0.8, 0.05, -0.3], np.float32)
    Tc2[:4] /= np.linalg.norm(Tc2[:4])
    Xt = np.stack([rng.uniform(-8, 8, 400), rng.uniform(-3, 3, 400), rng.uniform(5, 40, 400)],
                  -1).astype(np.float32)
    uv1 = _project_np(Tc1, Xt)[0] + rng.randn(400, 2) * 0.5
    uv2 = _project_np(Tc2, Xt)[0] + rng.randn(400, 2) * 0.5
    uv2[:40] += rng.uniform(5, 30, (40, 2))
    # an indefinite reduced system (K = 3 keyframes, the first fixed)
    H = rng.randn(3, 3, 36).astype(np.float32)
    H = H + H.reshape(3, 3, 6, 6).transpose(1, 0, 3, 2).reshape(3, 3, 36)
    return dict(T1=T1, T2=T2, Tm=Tm, X=X, uv=uv, A=A, A4=A4, S=S, b3=b3, Tc1=Tc1, Tc2=Tc2,
                uv1=uv1.astype(np.float32), uv2=uv2.astype(np.float32), H=H,
                bc=rng.randn(3, 6).astype(np.float32))


def _jax_fns(j, p):
    """The JAX package's functions on this module's inputs, as one program."""
    cam = JCFG.camera
    out = {}
    out["adjoint"] = j_se3.adjoint(j["T1"])
    out["relative_error"] = j_se3.relative_error(j["Tm"], j["T1"], j["T2"])
    out["jr_inv"] = j_se3.jr_inv_approx(out["relative_error"])
    out["front_point_jacobian"] = j_res.front_point_jacobian(cam, j["T1"], j["X"])
    out["bird_point_jacobian"] = j_res.bird_point_jacobian(j["T1"], j["X"])
    out["odom_residuals"] = j_res.odom_residuals(j["Tm"], j["T1"], j["T2"])
    out["front_error"] = j_res.front_error(cam, j["T1"], j["X"], j["uv"])
    out["bird_error"] = j_res.bird_error(j["T1"], j["X"], j["X"] * 0.5)
    out["srsv"] = j_linalg.smallest_right_singular_vectors(j["A"], 2)
    out["nullvec"] = j_linalg.nullvec(j["A4"])
    out["inv3"] = j_linalg.inv3(j["S"])
    out["solve3"] = j_linalg.solve3(j["S"], j["b3"])
    out["tri"] = j_tri.triangulate(cam, j["Tc1"], j["Tc2"], j["uv1"], j["uv2"],
                                   max_reproj_err=5.991, min_parallax_cos=0.9998)
    out["solve_reduced"] = j_ba._solve_reduced(j["H"], j["bc"], jnp.arange(3) == 0, 1e-4)
    out["ba"] = j_ba.bundle_adjust(cam, JCFG.ba, p["poses0"], p["fixed"],
                                   j_ba.PointBlocks(**p["front"]), j_ba.PointBlocks(**p["bird"]),
                                   j_ba.OdomEdges(**p["odom"]))
    return out


def _jax_refs():
    x, p = _inputs(), ba_problem()
    # a small program: XLA's backend at optimisation level 0 compiles it
    # with about half the CPU time
    out = jax.jit(_jax_fns).lower(x, p).compile({"xla_backend_optimization_level": 0})(x, p)
    return dict(jax.tree.map(np.asarray, out), inputs=x, ba_problem=p)


torch_refs.register("torch_ba", __file__, _jax_refs)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_ba")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, want,
                               rtol=rtol, atol=atol)


def test_se3_additions(ref):
    x = ref["inputs"]
    _close(t_se3.adjoint(_t(x["T1"])), ref["adjoint"])
    e = t_se3.relative_error(_t(x["Tm"]), _t(x["T1"]), _t(x["T2"]))
    _close(e, ref["relative_error"], atol=2e-4)
    _close(t_se3.jr_inv_approx(_t(ref["relative_error"])), ref["jr_inv"])


def test_residual_additions(ref):
    x = ref["inputs"]
    T1, T2, Tm, X, uv = (_t(x[k]) for k in ("T1", "T2", "Tm", "X", "uv"))
    _close(t_res.front_point_jacobian(CAM, T1, X), ref["front_point_jacobian"], rtol=1e-4,
           atol=1e-3)
    _close(t_res.bird_point_jacobian(T1, X), ref["bird_point_jacobian"])
    for got, want in zip(t_res.odom_residuals(Tm, T1, T2), ref["odom_residuals"]):
        _close(got, want, atol=5e-4)
    for got, want in zip(t_res.front_error(CAM, T1, X, uv), ref["front_error"]):
        _close(got, want, atol=1e-3)
    for got, want in zip(t_res.bird_error(T1, X, X * 0.5), ref["bird_error"]):
        _close(got, want)


def test_null_vectors(ref):
    """The sign of a singular vector is arbitrary: compare |<got, want>|."""
    x = ref["inputs"]
    got = t_linalg.smallest_right_singular_vectors(_t(x["A"]), 2).numpy()
    assert got.shape == ref["srsv"].shape == (64, 2, 9)
    np.testing.assert_allclose(np.abs(np.sum(got * ref["srsv"], -1)), 1.0, atol=1e-4)
    nv = t_linalg.nullvec(_t(x["A4"])).numpy()
    np.testing.assert_allclose(np.abs(np.sum(nv * ref["nullvec"], -1)), 1.0, atol=1e-4)


def test_inv3_solve3(ref):
    x = ref["inputs"]
    _close(t_linalg.inv3(_t(x["S"])), ref["inv3"])
    _close(t_linalg.solve3(_t(x["S"]), _t(x["b3"])), ref["solve3"])


def test_triangulate(ref):
    x = ref["inputs"]
    got = t_tri.triangulate(CAM, _t(x["Tc1"]), _t(x["Tc2"]), _t(x["uv1"]), _t(x["uv2"]),
                            max_reproj_err=5.991, min_parallax_cos=0.9998)
    want = ref["tri"]
    assert 200 < want.valid.sum() < 390      # the outliers and far points are refused
    assert (got.valid.numpy() == want.valid).mean() >= 0.99
    assert (got.geom_ok.numpy() == want.geom_ok).mean() >= 0.99
    both = got.valid.numpy() & want.valid
    np.testing.assert_allclose(got.Xw.numpy()[both], want.Xw[both], atol=1e-3)
    np.testing.assert_allclose(got.parallax.numpy()[both], want.parallax[both], atol=1e-6)


def test_reduced_solve_lu_branch(ref):
    """An indefinite reduced system: the Cholesky fails and the LU solve of the
    same system is taken, as in the JAX package."""
    x = ref["inputs"]
    Hcc = _t(x["H"]).reshape(3, 3, 6, 6).permute(0, 2, 1, 3).contiguous()
    fixed = torch.tensor([True, False, False])
    H, b = t_ba._reduced_system(Hcc, _t(x["bc"]), fixed, 1e-4)
    assert int(torch.linalg.cholesky_ex(H).info) > 0
    got = t_ba._solve_reduced(Hcc, _t(x["bc"]), fixed, 1e-4)
    _close(got, ref["solve_reduced"], rtol=1e-3, atol=1e-4)
    _close(got.reshape(-1), torch.linalg.solve(H, b), rtol=1e-5, atol=1e-6)
    assert torch.all(got[0] == 0)


def test_edge_blocks_skip_empty_chunks(monkeypatch):
    """The pose graph's skip of the chunks without a valid edge: H and g
    equal bit for bit to those of every chunk, at 64-edge chunks over 330
    edges of which only chunks 0, 2 and the last have nonzero weight."""
    monkeypatch.setattr(t_ba, "EDGE_CHUNK", 64)
    g = torch.Generator().manual_seed(3)
    K, E = 12, 330
    i, j = (torch.randint(0, K, (E,), generator=g, dtype=torch.int32) for _ in range(2))
    Ji, Jj = (torch.randn(E, 6, 6, generator=g) for _ in range(2))
    r = torch.randn(E, 6, generator=g)
    w = torch.zeros(E)
    for s in (0, 128, 320):
        w[s:s + 10] = torch.rand(10, generator=g) * 100
    H, b = t_ba.edge_blocks(K, i, j, Ji, Jj, r, w)
    H2, b2 = t_ba.edge_blocks(K, i, j, Ji, Jj, r, w, chunks=[0, 128, 320])
    assert torch.equal(H, H2) and torch.equal(b, b2)
    assert not torch.equal(H, t_ba.edge_blocks(K, i, j, Ji, Jj, r, w, chunks=[0, 128])[0])


@pytest.fixture(scope="module")
def ba_run(ref):
    p = ref["ba_problem"]
    out = t_ba.bundle_adjust(
        CAM, CFG.ba, _t(p["poses0"]), _t(p["fixed"]),
        convert.from_numpy(t_ba.PointBlocks, p["front"], "cpu"),
        convert.from_numpy(t_ba.PointBlocks, p["bird"], "cpu"),
        convert.from_numpy(t_ba.OdomEdges, p["odom"], "cpu"))
    return convert.to_numpy(out)


def _pose_err(a, b):
    return t_se3.log(t_se3.compose(_t(a), t_se3.inverse(_t(b)))).abs().max().item()


def test_bundle_adjust_poses(ref, ba_run):
    want = ref["ba"]
    p = ref["ba_problem"]
    assert _pose_err(want.poses, p["poses_true"]) < 0.01
    assert _pose_err(ba_run["poses"], want.poses) < 2e-4
    np.testing.assert_array_equal(ba_run["poses"][0], p["poses0"][0])   # the fixed gauge


def test_bundle_adjust_points(ref, ba_run):
    want = ref["ba"]
    np.testing.assert_allclose(ba_run["front_Xw"], want.front_Xw, atol=5e-3)
    np.testing.assert_allclose(ba_run["bird_Xw"], want.bird_Xw, atol=5e-3)


def test_bundle_adjust_classification(ref, ba_run):
    want = ref["ba"]
    assert not want.front_inlier[:10, 0].any()
    np.testing.assert_array_equal(ba_run["front_inlier"], want.front_inlier)
    np.testing.assert_array_equal(ba_run["bird_inlier"], want.bird_inlier)


def test_convert_ba_tuples(ref):
    p = ref["ba_problem"]
    pb = convert.from_numpy(t_ba.PointBlocks, p["front"], "cpu")
    assert pb.kf_idx.dtype == torch.int32 and pb.valid.dtype == torch.bool
    for k, v in p["front"].items():
        np.testing.assert_array_equal(getattr(pb, k).numpy(), v)
    oe = convert.from_numpy(t_ba.OdomEdges, p["odom"], "cpu")
    np.testing.assert_array_equal(oe.T_meas.numpy(), p["odom"]["T_meas"])


@pytest.mark.parametrize("shape", [(64, 4, 4), (64, 8, 9), (64, 12, 5)])
def test_householder_r(shape):
    """The batched Householder R is LAPACK's up to the signs of its rows."""
    A = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    R = t_linalg.householder_r(A)
    _, R0 = torch.linalg.qr(A)
    assert R.shape == R0.shape
    _close(R.abs(), R0.abs().numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(R, torch.triu(R))
