"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and ``nvcc`` and skip without them.  Run them on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Edge
cases at small shapes: ragged tiles, invalid rows, ties, negative corners;
``chip_smoke.py`` holds the kernels at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_matcher, cuda_patch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shapes", [[(64, 128)], [(57, 131), (100, 200), (7, 9), (400, 950)]])
def test_fast_levels(dev, shapes):
    rng = np.random.RandomState(0)
    levels = [torch.from_numpy(rng.rand(*s).astype(np.float32) * 255).to(dev) for s in shapes]
    n0 = cuda_fast.fast_detect_levels.launches
    got = cuda_fast.fast_detect_levels(levels, 15.0, 5.0)
    ref = cuda_fast.fast_detect_levels_plain(levels, 15.0, 5.0)
    assert cuda_fast.fast_detect_levels.launches == n0 + 1
    for (s, r), (s0, r0) in zip(got, ref):
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(r, r0, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,side", [(1, 37), (300, 37), (50, 5)])
def test_patch_gather(dev, n, side):
    rng = np.random.RandomState(n)
    img = torch.from_numpy(rng.rand(200, 333).astype(np.float32)).to(dev)
    yx = torch.from_numpy(np.stack([rng.randint(-10, 210, n), rng.randint(-10, 340, n)], -1)
                          .astype(np.int32)).to(dev)
    assert torch.equal(cuda_patch.extract_patches(img, yx, side),
                       cuda_patch.extract_patches_plain(img, yx, side))


def _problem(dev, na, nb, seed):
    rng = np.random.RandomState(seed)
    a = np.where(rng.rand(na, 256) > 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) > 0.5, 1.0, -1.0).astype(np.float32)
    k = min(na, nb)
    b[:k] = a[:k] * np.where(rng.rand(k, 256) < 0.05, -1.0, 1.0)
    b[k // 2: k] = b[: k - k // 2]            # duplicate targets: ties
    a[-3:] = 0.0                               # all-zero rows, as invalid keypoints carry
    uv_a = rng.uniform(0, 200, (na, 2)).astype(np.float32)
    uv_b = np.concatenate([uv_a[:k] + rng.randn(k, 2).astype(np.float32) * 3,
                           rng.uniform(0, 200, (nb - k, 2)).astype(np.float32)])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(a).bfloat16(), t(uv_a), t(rng.randint(0, 8, na).astype(np.int32)),
            t(rng.rand(na) > 0.1), t(b).bfloat16(), t(uv_b),
            t(rng.uniform(5, 40, nb).astype(np.float32)),
            t(rng.randint(-1, 8, nb).astype(np.float32)), t(rng.rand(nb) > 0.1))


@pytest.mark.parametrize("na,nb", [(64, 32), (100, 333), (257, 2049)])
@pytest.mark.parametrize("level_window", [False, True])
@pytest.mark.parametrize("ratio", [None, 0.8])
def test_projection_match(dev, na, nb, level_window, ratio):
    prob = _problem(dev, na, nb, na + nb)
    got = cuda_matcher.fused_projection_match(*prob, max_dist=100.0, level_window=level_window,
                                              ratio=ratio)
    ref = cuda_matcher.fused_projection_match_plain(*prob, max_dist=100.0,
                                                    level_window=level_window, ratio=ratio)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("na,nb", [(64, 32), (100, 333), (257, 2049)])
@pytest.mark.parametrize("level_window", [False, True])
def test_projection_match_dual(dev, na, nb, level_window):
    prob = _problem(dev, na, nb, 7 * na + nb)
    got = cuda_matcher.fused_projection_match_dual(*prob, max_dist=100.0, r2_scale=2.0,
                                                   level_window=level_window)
    ref = cuda_matcher.fused_projection_match_dual_plain(*prob, max_dist=100.0, r2_scale=2.0,
                                                         level_window=level_window)
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert torch.equal(x, y)


def _pose_problem(dev, n, nb, seed, outlier_frac=0.1):
    """tests/test_pallas_pose_opt.py:make_problem at n front and nb bird
    observations, in numpy, on ``dev``."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.geometry import camera, se3
    from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
    rng = np.random.RandomState(seed)
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    T_true = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.3, -0.1, 0.2]))
    uv = camera.project_pinhole(SystemConfig().camera,
                                se3.transform(T_true, torch.from_numpy(Xw))).numpy()
    uv += rng.randn(n, 2).astype(np.float32) * 0.5
    uv[: int(outlier_frac * n)] += rng.uniform(30, 80, (int(outlier_frac * n), 2))
    Xb = np.stack([rng.uniform(2, 12, nb), rng.uniform(-5, 5, nb), np.zeros(nb)],
                  -1).astype(np.float32)
    Xc = se3.transform(T_true, torch.from_numpy(Xb)).numpy() + rng.randn(nb, 3) * 0.01
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    return (T_true.to(dev), FrontObs(t(Xw), t(uv), t(rng.uniform(0.5, 1.5, n)), ones(n)),
            BirdObs(t(Xb), t(Xc), t(rng.uniform(0.5, 1.5, nb)), ones(nb)))


@pytest.mark.parametrize("n,nb,prior_info,case", [
    (300, 80, 0.0, "base"), (1000, 777, 100.0, "ragged"), (2048, 2048, 100.0, "main path"),
    (16, 200, 0.0, "bird only"), (513, 1, 100.0, "one bird row"), (8, 8, 0.0, "too few")])
def test_pose_optimization(dev, n, nb, prior_info, case):
    """The kernel against its plain version at the JAX package's bounds for
    its own fused kernel: pose within 1e-3, inlier flips under 2%,
    n_inliers within 5; the seed comes back with fewer than 3 front rows."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    cfg = SystemConfig()
    T_true, front, bird = _pose_problem(dev, n, nb, n + nb, 0.0 if case == "too few" else 0.1)
    T0 = se3.retract(T_true, torch.tensor([0.01, 0, -0.01, 0.05, 0.02, 0], device=dev))
    if case == "bird only":
        front = front._replace(valid=torch.arange(n, device=dev) < 4)
    if case == "too few":
        front = front._replace(valid=torch.arange(n, device=dev) < 2)
        bird = bird._replace(valid=torch.zeros(nb, dtype=torch.bool, device=dev))
    n0 = cuda_pose_opt.pose_optimization.launches
    got = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0, front, bird, T0, prior_info)
    ref = cuda_pose_opt.pose_optimization_plain(cfg.camera, cfg.ba, T0, front, bird, T0,
                                                prior_info)
    assert cuda_pose_opt.pose_optimization.launches == n0 + 1
    d = se3.log(se3.compose(got.Tcw.cpu(), se3.inverse(ref.Tcw.cpu()))).abs().max().item()
    assert d < 1e-3
    assert (got.front_inlier != ref.front_inlier).float().mean().item() < 0.02
    assert (got.bird_inlier != ref.bird_inlier).float().mean().item() < 0.02
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 5
    assert got.n_inliers.dtype == torch.int32 and got.front_inlier.dtype == torch.bool
    if case == "too few":
        assert torch.equal(got.Tcw, T0)


def test_se3_functions_of_the_pose_kernel(dev):
    """The kernel's retraction (small-angle branch included: theta^2 < 1e-12)
    and its exact SE3 log against geometry/se3.py."""
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    rng = np.random.RandomState(0)
    n = 96
    T = se3.exp(torch.from_numpy(rng.randn(n, 6).astype(np.float32)))
    Tp = se3.retract(T, torch.from_numpy(rng.randn(n, 6).astype(np.float32) * 0.1))
    dx = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    dx[:32, :3] *= 1e-7
    dx[32:64] *= 1e-3
    Tret, logrel = cuda_pose_opt.se3_check(T.to(dev), dx.to(dev), Tp.to(dev))
    torch.testing.assert_close(Tret.cpu(), se3.retract(T, dx), rtol=0, atol=2e-6)
    torch.testing.assert_close(logrel.cpu(), se3.log(se3.compose(T, se3.inverse(Tp))),
                               rtol=0, atol=2e-5)


def _words(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("na,nb", [(1, 1), (33, 257), (100, 130), (257, 2049)])
def test_hamming_matrix_packed(dev, na, nb):
    rng = np.random.RandomState(na + nb)
    a, b = (torch.from_numpy(_words(rng, k)).to(dev) for k in (na, nb))
    n0 = cuda_matcher.hamming_matrix_packed.launches
    got = cuda_matcher.hamming_matrix_packed(a, b)
    assert cuda_matcher.hamming_matrix_packed.launches == n0 + 1
    assert torch.equal(got, cuda_matcher.hamming_matrix_packed_plain(a, b))


@pytest.mark.parametrize("na,nb,radius,case", [
    (200, 600, 60.0, "random"), (129, 1100, 60.0, "ties"), (20, 20, 50.0, "no valid"),
    (300, 5000, 1e4, "every pair")])
def test_fused_masked_match(dev, na, nb, radius, case):
    rng = np.random.RandomState(na + nb)
    a, b = _words(rng, na), _words(rng, nb)
    uva = rng.rand(na, 2).astype(np.float32) * 400
    uvb = rng.rand(nb, 2).astype(np.float32) * 400
    vb = rng.rand(nb) > 0.2
    if case == "ties":   # across the kernel's 256-column tiles and inside one
        for q, cols in ((0, (300, 700, 1099)), (1, (5, 6))):
            b[list(cols)], uvb[list(cols)], vb[list(cols)] = a[q], uva[q], True
    if case == "no valid":
        vb[:] = False
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a), t(uva), t(b), t(uvb), t(vb), radius)
    got = cuda_matcher.fused_masked_match(*args)
    ref = cuda_matcher.fused_masked_match_plain(*args)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    if case == "ties":
        assert got[2][:2].tolist() == [300, 5] and got[1][:2].tolist() == [0.0, 0.0]
    if case == "no valid":
        assert (got[2] == -1).all() and (got[0] == 1e9).all()
