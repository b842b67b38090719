"""Parity of the port's pose optimisation (the plain, non-fused route) with
the JAX package on the problem of ``tests/test_pallas_pose_opt.py``, at that
test's bounds: pose within 1e-3 (max abs of the se3 log of the difference),
inlier flips under 2%, ``n_inliers`` within 5.  Every problem here has the
same shapes, so one JAX compile serves them all; JAX solves every problem
once per run (``torch_refs.shared``).  On the CPU the kernel's
wrapper (``solvers/cuda_pose_opt.py``) runs the plain route."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.solvers import pose_opt as j_po
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import camera as t_cam
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
from fishbirdeyevisualslam_torch.solvers import pose_opt as t_po

import torch_refs

torch.set_num_threads(1)

CFG = SystemConfig()
JCFG = JaxConfig()


def make_problem(n=300, nb=80, seed=0, outlier_frac=0.1, noise=0.5):
    """The problem of tests/test_pallas_pose_opt.py:make_problem, in numpy."""
    rng = np.random.RandomState(seed)
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    T_true = t_se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.3, -0.1, 0.2]))
    uv = t_cam.project_pinhole(CFG.camera, t_se3.transform(T_true, torch.from_numpy(Xw))).numpy()
    uv += rng.randn(n, 2).astype(np.float32) * noise
    n_out = int(outlier_frac * n)
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2)).astype(np.float32)
    Xb = np.stack([rng.uniform(2, 12, nb), rng.uniform(-5, 5, nb), np.zeros(nb)],
                  -1).astype(np.float32)
    Xc = t_se3.transform(T_true, torch.from_numpy(Xb)).numpy()
    Xc += rng.randn(nb, 3).astype(np.float32) * 0.01
    front = (Xw, uv.astype(np.float32), np.ones(n, np.float32), np.ones(n, bool))
    bird = (Xb, Xc.astype(np.float32), np.ones(nb, np.float32), np.ones(nb, bool))
    return T_true.numpy(), front, bird


# one compile for every problem: prior_info enters as a traced scalar; XLA's
# backend at optimisation level 0 compiles it with about half the CPU time
_jax_solver = jax.jit(lambda T0, fr, bi, pT, info: j_po.pose_optimization(
    JCFG.camera, JCFG.ba, T0, fr, bi, prior_T=pT, prior_info=info, use_fused=False),
    compiler_options={"xla_backend_optimization_level": 0})


def _problems():
    """Every problem this module solves with both packages:
    name -> (true pose, seed pose, front, bird, prior_info)."""
    identity = np.asarray(j_se3.identity())
    probs = {}
    for seed in (0, 1, 2):
        T_true, front, bird = make_problem(seed=seed)
        probs[f"seed {seed}"] = (T_true, identity, front, bird, 0.0)
    for seed in (3, 4):
        T_true, front, bird = make_problem(seed=seed)
        T0 = np.asarray(j_se3.retract(jnp.asarray(T_true), jnp.asarray(
            [0.01, 0, -0.01, 0.05, 0.02, 0], jnp.float32)))
        probs[f"prior {seed}"] = (T_true, T0, front, bird, 100.0)
    # tests/test_pallas_pose_opt.py:73's case: the front starved to 4 valid
    # rows, the bird view carrying the pose
    T_true, front, bird = make_problem(seed=5, outlier_frac=0.0)
    probs["bird only"] = (T_true, identity, front[:3] + (np.arange(300) < 4,), bird, 0.0)
    T_true, front, bird = make_problem(outlier_frac=0.0)
    T0 = np.asarray(j_se3.exp(jnp.asarray([0, 0, 0.1, 1.0, 0, 0], jnp.float32)))
    probs["too few"] = (T_true, T0, front[:3] + (np.arange(300) < 2,),
                        bird[:3] + (np.zeros(80, bool),), 0.0)
    return probs


def _jax_refs():
    """Each problem with JAX's solution, as numpy trees."""
    return {name: (prob, jax.tree.map(np.asarray, _jax_solver(
        jnp.asarray(T0), j_po.FrontObs(*map(jnp.asarray, front)),
        j_po.BirdObs(*map(jnp.asarray, bird)), jnp.asarray(T0), jnp.float32(prior_info))))
        for name, prob in _problems().items() for _, T0, front, bird, prior_info in [prob]}


torch_refs.register("torch_pose_opt_jax", __file__, _jax_refs)


@pytest.fixture(scope="module")
def jax_refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_pose_opt_jax")


def _solve_both(jax_refs, name):
    """The port's plain LM on a problem, beside JAX's solution of it.
    Returns (true pose, seed pose, port's result, JAX's result)."""
    (T_true, T0, front, bird, prior_info), ref = jax_refs[name]
    T = torch.from_numpy(np.array(T0))
    out = t_po.pose_optimization(CFG.camera, CFG.ba, T,
                                 t_po.FrontObs(*map(torch.from_numpy, front)),
                                 t_po.BirdObs(*map(torch.from_numpy, bird)),
                                 prior_T=T, prior_info=prior_info)
    return T_true, T0, out, ref


def _pose_diff(a, b):
    d = j_se3.log(j_se3.compose(jnp.asarray(a), j_se3.inverse(jnp.asarray(b))))
    return float(np.abs(np.asarray(d)).max())


def _check(out, ref):
    assert _pose_diff(out.Tcw.numpy(), ref.Tcw) < 1e-3
    assert (out.front_inlier.numpy() != np.asarray(ref.front_inlier)).mean() < 0.02
    assert (out.bird_inlier.numpy() != np.asarray(ref.bird_inlier)).mean() < 0.02
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax(jax_refs, seed):
    T_true, _, out, ref = _solve_both(jax_refs, f"seed {seed}")
    _check(out, ref)
    if seed == 0:  # the JAX test's own problem lands on the true pose
        assert _pose_diff(out.Tcw.numpy(), T_true) < 5e-3


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_jax_with_prior(jax_refs, seed):
    _, _, out, ref = _solve_both(jax_refs, f"prior {seed}")
    _check(out, ref)


def test_bird_only_observations_match_jax(jax_refs):
    """tests/test_pallas_pose_opt.py:73's case: the front starved to 4 valid
    rows, the bird view carrying the pose (here at this module's shapes)."""
    T_true, _, out, ref = _solve_both(jax_refs, "bird only")
    _check(out, ref)
    assert int(out.n_inliers) == 4
    assert _pose_diff(out.Tcw.numpy(), T_true) < 2e-2


@pytest.mark.parametrize("prior_info", [0.0, 100.0])
def test_kernel_wrapper_on_cpu_is_the_plain_route(prior_info):
    _, front, bird = make_problem(seed=6)
    T0 = t_se3.exp(torch.tensor([0.01, 0.0, -0.02, 0.1, 0.05, -0.1]))
    fr = t_po.FrontObs(*map(torch.from_numpy, front))
    bi = t_po.BirdObs(*map(torch.from_numpy, bird))
    n0 = cuda_pose_opt.pose_optimization.launches
    got = cuda_pose_opt.pose_optimization(CFG.camera, CFG.ba, T0, fr, bi, None, prior_info)
    ref = cuda_pose_opt.pose_optimization_plain(CFG.camera, CFG.ba, T0, fr, bi, T0, prior_info)
    assert cuda_pose_opt.pose_optimization_plain is t_po.pose_optimization
    assert cuda_pose_opt.pose_optimization.launches == n0   # nothing launched on the CPU
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_too_few_returns_seed(jax_refs):
    _, T0, out, ref = _solve_both(jax_refs, "too few")
    np.testing.assert_allclose(out.Tcw.numpy(), T0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref.Tcw), T0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chol_solve6(seed):
    """The unrolled Cholesky solves SPD systems, including the 1e-10-regularised
    empty system the LM meets with no observations."""
    rng = np.random.RandomState(seed)
    A = rng.randn(6, 6)
    H = (A @ A.T + 0.5 * np.eye(6) if seed < 3 else 1e-10 * np.eye(6)).astype(np.float32)
    g = rng.randn(6).astype(np.float32)
    x = t_po._chol_solve6(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    ref = np.asarray(j_po._chol_solve6(jnp.asarray(H), jnp.asarray(g)))
    np.testing.assert_allclose(x, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max())
