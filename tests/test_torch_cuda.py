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


def _fast_case(case, rng):
    """Level images of one edge case of the FAST kernel's design (30 x 16
    output tiles of one warp each, a 4 px halo)."""
    rand = lambda h, w: rng.rand(h, w).astype(np.float32) * 255
    if case == "narrower than the tile":
        return [rand(60, 20), rand(45, 7), rand(33, 29), rand(70, 31), rand(12, 30)]
    if case == "fewer than 7 rows":
        return [rand(6, 100), rand(5, 33), rand(1, 64), rand(2, 2), rand(7, 50)]
    if case == "plateaus":  # few grey levels: equal scores side by side
        return [(rng.randint(0, 3, (90, 97)) * 40).astype(np.float32),
                np.kron(rng.randint(0, 2, (20, 20)), np.ones((4, 4))).astype(np.float32) * 100]
    if case == "differences at the thresholds":  # steps of 5: d == 5 and d == 15 occur
        img = (rng.randint(0, 8, (80, 70)) * 5).astype(np.float32)
        return [img, img + 0.5]
    if case == "32 levels":
        return [rand(10 + 3 * i, 5 + 7 * i) for i in range(32)]
    from scipy.ndimage import gaussian_filter
    from fishbirdeyevisualslam_torch.ops import image as image_ops
    levels = []
    for shape in ((400, 950), (384, 384)):   # "main path levels": a frame's 16 levels
        img = gaussian_filter(rng.rand(*shape), 1.5)
        img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)
        levels += [l.numpy() for l in image_ops.build_pyramid(torch.from_numpy(img), 8, 1.2)]
    return levels


@pytest.mark.parametrize("case", ["narrower than the tile", "fewer than 7 rows", "plateaus",
                                  "differences at the thresholds", "32 levels",
                                  "main path levels"])
def test_fast_levels_edges(dev, case):
    """The FAST kernel bit-exact against its plain version on the edges of
    its design: levels narrower than a tile or too short for any interior
    row, plateaus of equal scores (the NMS keeps every maximum, s >= mx),
    circle differences exactly equal to a threshold (the tests are strict),
    the level table's 32 entries, and the main path's 16 level shapes."""
    levels = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in _fast_case(case, np.random.RandomState(1))]
    n0 = cuda_fast.fast_detect_levels.launches
    got = cuda_fast.fast_detect_levels(levels, 15.0, 5.0)
    assert cuda_fast.fast_detect_levels.launches == n0 + 1
    ref = cuda_fast.fast_detect_levels_plain(levels, 15.0, 5.0)
    for (s, r), (s0, r0) in zip(got, ref):
        assert torch.equal(s, s0) and torch.equal(r, r0)
    n_corners = sum(int((s > 0).sum()) for s, _ in got)
    if case == "fewer than 7 rows":
        assert n_corners == sum(int((s > 0).sum()) for s, _ in got[-1:]) and n_corners > 0
    else:
        assert n_corners > 0
    if case == "plateaus":  # some maxima are kept beside an equal neighbour
        s = got[0][0]
        assert bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] > 0)).any())


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


def _edge_problem(dev, case, edge_scales=(1.0,)):
    """The arguments of one edge case of the matchers' design.  With
    "window edge", every target sits exactly on a window's edge: |du| or
    |dv| (or both) equal to r times the next of ``edge_scales``."""
    na, nb = {"ragged": (300, 1000), "65536 targets": (100, 65536),
              "ties across tiles and splits": (129, 4096)}.get(case, (200, 700))
    pm1_a, uv_a, oct_a, va, pm1_b, uv_b, radius, pred, vb = _problem(dev, na, nb, nb + 3)
    radius_arg = radius
    if case == "window edge":  # integer positions: |du| or |dv| exactly r * scale
        uv_a = uv_a.round()
        radius = radius.round()
        q = torch.arange(nb, device=dev) % na
        sign = torch.where(torch.arange(nb, device=dev) % 2 == 0, 1.0, -1.0)
        scales = torch.tensor(edge_scales, device=dev)[(torch.arange(nb, device=dev) // 3)
                                                       % len(edge_scales)]
        step = sign * radius * scales
        uv_b = uv_a[q].clone()
        uv_b[0::3, 0] += step[0::3]
        uv_b[1::3, 1] += step[1::3]
        uv_b[2::3] += step[2::3][:, None]
        radius_arg = radius
    if case == "ties across tiles and splits":
        cols = (5, 70, 1500, nb - 1)
        for c in cols:
            pm1_b[c], uv_b[c], vb[c], pred[c] = pm1_a[0], uv_a[0], True, -1.0
        va[0] = True
    if case == "no valid query":
        va = torch.zeros_like(va)
    if case == "no valid target":
        vb = torch.zeros_like(vb)
    if case == "scalar radius, int32 pred":
        radius_arg = 30.0
        pred = pred.to(torch.int32)
    if case.startswith("int"):  # pred as the tracker's levels: -1 where no estimate
        assert bool((pred < 0).any())
        pred = pred.to(torch.int32 if case.startswith("int32") else torch.int64)
    if case == "strided gate inputs":
        uv_a = torch.stack([uv_a, uv_a + 1], -1)[..., 0]        # strides (2, 1) x 2
        uv_b = uv_b.t().contiguous().t()                          # column-major (1, nb)
        radius_arg = radius[:1].expand(nb)                        # stride 0
        pred = pred.to(torch.int64)
    return pm1_a, uv_a, oct_a, va, pm1_b, uv_b, radius_arg, pred, vb


@pytest.mark.parametrize("case", ["window edge", "ties across tiles and splits", "ragged",
                                  "65536 targets", "no valid query", "no valid target",
                                  "scalar radius, int32 pred", "strided gate inputs"])
@pytest.mark.parametrize("level_window", [False, True])
def test_projection_match_edges(dev, case, level_window):
    """The single matcher exactly equal to its plain version on the edges of
    its design: the window's <=, ties in different 64-column tiles and
    target splits, ragged row and column tiles, the key's 65536-target
    limit, invalid rows, and the gate's inputs in the forms the tracker
    passes (one radius by value, int32 levels) or with strides."""
    args = _edge_problem(dev, case)
    n0 = cuda_matcher.fused_projection_match.launches
    got = cuda_matcher.fused_projection_match(*args, max_dist=100.0, level_window=level_window)
    assert cuda_matcher.fused_projection_match.launches == n0 + 1
    ref = cuda_matcher.fused_projection_match_plain(*args, max_dist=100.0,
                                                    level_window=level_window)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    if case == "ties across tiles and splits":
        assert int(got.idx[0]) == 5 and float(got.dist[0]) == 0.0
    if case.startswith("no valid"):
        assert (got.idx == -1).all()
    if case == "window edge":
        assert int(got.count) > 0


@pytest.mark.parametrize("case", ["window edge", "ties across tiles and splits", "ragged",
                                  "65536 targets", "no valid query", "no valid target",
                                  "int32 pred with -1 holes", "int64 pred with -1 holes",
                                  "scalar radius, int32 pred", "strided gate inputs"])
@pytest.mark.parametrize("level_window", [False, True])
def test_projection_match_dual_edges(dev, case, level_window):
    """The dual matcher, on the single matcher's design, exactly equal to its
    plain version on the same edges, with targets exactly on the narrow (r)
    and on the wide (2 r) window's edge."""
    args = _edge_problem(dev, case, edge_scales=(1.0, 2.0))
    n0 = cuda_matcher.fused_projection_match_dual.launches
    got = cuda_matcher.fused_projection_match_dual(*args, max_dist=100.0, r2_scale=2.0,
                                                   level_window=level_window)
    assert cuda_matcher.fused_projection_match_dual.launches == n0 + 1
    ref = cuda_matcher.fused_projection_match_dual_plain(*args, max_dist=100.0, r2_scale=2.0,
                                                         level_window=level_window)
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert torch.equal(x, y)
    if case == "ties across tiles and splits":
        assert all(int(g.idx[0]) == 5 and float(g.dist[0]) == 0.0 for g in got)
    if case.startswith("no valid"):
        assert all((g.idx == -1).all() for g in got)
    if case == "window edge":
        assert int(got[0].count) > 0 and int(got[1].count) > int(got[0].count)


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


def _flips(a, b) -> float:
    return (a != b).float().mean().item() if a.numel() else 0.0


@pytest.mark.parametrize("n,nb,prior_info,case", [
    (300, 80, 0.0, "base"), (1000, 777, 100.0, "ragged"), (2048, 2048, 100.0, "main path"),
    (16, 200, 0.0, "bird only"), (513, 1, 100.0, "one bird row"), (8, 8, 0.0, "too few"),
    (4096, 4096, 100.0, "rows past the registers"), (6000, 4000, 100.0, "uneven slices"),
    (0, 300, 100.0, "no front rows"), (300, 0, 0.0, "no bird rows")])
def test_pose_optimization(dev, n, nb, prior_info, case):
    """The kernel against its plain version at the JAX package's bounds for
    its own fused kernel: pose within 1e-3, inlier flips under 2%,
    n_inliers within 5; the seed comes back with fewer than 3 front rows.
    The cluster's 8 x 256 row threads hold 2 rows each in registers: the
    main path's 2048 + 2048 rows fill them, larger inputs also go through the
    rows read from global memory at each evaluation."""
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
    assert _flips(got.front_inlier, ref.front_inlier) < 0.02
    assert _flips(got.bird_inlier, ref.bird_inlier) < 0.02
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 5
    assert got.n_inliers.dtype == torch.int32 and got.front_inlier.dtype == torch.bool
    if case in ("too few", "no front rows"):
        assert torch.equal(got.Tcw, T0)


def test_pose_optimization_bit_identical(dev):
    """Two launches on one input agree bit for bit: the cluster's reduction
    runs in a fixed order."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    cfg = SystemConfig()
    T_true, front, bird = _pose_problem(dev, 2048, 2048, 11)
    T0 = se3.retract(T_true, torch.tensor([0.01, 0, -0.01, 0.05, 0.02, 0], device=dev))
    a = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0, front, bird, T0, 100.0)
    b = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0, front, bird, T0, 100.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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


def _masked_case(rng, case, a, uva, b, uvb, vb, radius):
    """Edits a random problem into one edge case of the masked match's design
    (targets binned into cells of side s > radius, 3 x 3 cells searched per
    query, the targets of a neighbourhood cut into chunks)."""
    na, nb = len(a), len(b)
    if case == "ties":   # three equal targets for query 0, two for query 1
        for q, cols in ((0, (300, 700, 1099)), (1, (5, 6))):
            b[list(cols)], uvb[list(cols)], vb[list(cols)] = a[q], uva[q], True
    if case == "ties in several cells":   # equal distances near each of 40 queries
        for q in range(0, 120, 3):
            cols = rng.choice(nb, 3, replace=False)
            b[cols], vb[cols] = a[q] ^ (1 << (q % 31)), True
            uvb[cols] = uva[q] + rng.uniform(-radius, radius, (3, 2)).astype(np.float32)
    if case == "no valid":
        vb[:] = False
    if case == "all valid":
        vb[:] = True
    if case == "window edges":   # at u_q +- r and v_q +- r exactly, and one ulp outside
        rf, k = np.float32(radius), 0
        for q in range(40):
            for du, dv in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)):
                for out in (False, True):
                    u = np.float32(uva[q, 0] + np.float32(du) * rf)
                    v = np.float32(uva[q, 1] + np.float32(dv) * rf)
                    if out:
                        u = np.nextafter(u, np.float32(du * np.inf)) if du else u
                        v = np.nextafter(v, np.float32(dv * np.inf)) if dv else v
                    uvb[k], vb[k], b[k] = (u, v), True, a[q] ^ (1 << (k % 7))
                    k += 1
    if case == "cell edges":   # on the cells' edges and one ulp either side of them
        side = np.float32(1.0) / np.float32(cuda_matcher.masked_cell_scale(radius))
        for arr in (uva, uvb):
            e = (rng.randint(0, 7, arr.shape).astype(np.float32) * side).astype(np.float32)
            shift = rng.randint(-1, 2, arr.shape)
            e = np.where(shift > 0, np.nextafter(e, np.float32(np.inf)), e)
            arr[:] = np.where(shift < 0, np.nextafter(e, np.float32(-np.inf)), e)
    if case == "r = 0, coincident":
        uvb[: nb // 2] = uva[rng.randint(0, na, nb // 2)]
        uvb[nb // 2:] = np.round(uvb[nb // 2:])
        uva[: na // 2] = np.round(uva[: na // 2])
    if case == "one cell":
        uva[:] = rng.rand(na, 2) * 10 + 3
        uvb[:] = rng.rand(nb, 2) * 10 + 3
    if case == "nan, inf, 1e6":
        vals = np.array([np.nan, np.inf, -np.inf, 1e6, -1e6, 3e38, 0.0, -0.0], np.float32)
        for arr in (uva, uvb):
            m = rng.rand(*arr.shape) < 0.3
            arr[m] = vals[rng.randint(0, len(vals), m.sum())]
        uvb[:20], vb[:20] = uva[:20], True
    if case == "clustered":   # every target in one square of two radii
        uvb[:] = rng.rand(nb, 2) * 2 * radius + 150


@pytest.mark.parametrize("na,nb,radius,case", [
    (200, 600, 60.0, "random"), (129, 1100, 60.0, "ties"), (20, 20, 50.0, "no valid"),
    (300, 5000, 1e4, "every pair"), (200, 600, 37.3, "window edges"),
    (200, 700, 40.0, "cell edges"), (200, 600, 0.0, "r = 0, coincident"),
    (300, 3000, 50.0, "one cell"), (200, 600, 60.0, "nan, inf, 1e6"),
    (200, 600, float("inf"), "nan, inf, 1e6"), (200, 600, float("nan"), "random"),
    (1, 333, 60.0, "random"), (50, 1, 60.0, "all valid"), (1, 1, 1e4, "all valid"),
    (257, 2049, 60.0, "random"), (300, 2500, 50.0, "clustered"),
    (300, 1600, 60.0, "ties in several cells"), (64, 1 << 20, 50.0, "random")])
def test_fused_masked_match(dev, na, nb, radius, case):
    """Exactly the plain version (best, second, idx), one launch counted per
    call, and no host read in the call."""
    rng = np.random.RandomState(na + nb)
    a, b = _words(rng, na), _words(rng, nb)
    uva = rng.rand(na, 2).astype(np.float32) * 400
    uvb = rng.rand(nb, 2).astype(np.float32) * 400
    vb = rng.rand(nb) > 0.2
    _masked_case(rng, case, a, uva, b, uvb, vb, radius)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a), t(uva), t(b), t(uvb), t(vb), radius)
    n0 = cuda_matcher.fused_masked_match.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cuda_matcher.fused_masked_match(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_matcher.fused_masked_match.launches == n0 + 1
    ref = cuda_matcher.fused_masked_match_plain(*args)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    if case == "ties":
        assert got[2][:2].tolist() == [300, 5] and got[1][:2].tolist() == [0.0, 0.0]
    if case == "no valid":
        assert (got[2] == -1).all() and (got[0] == 1e9).all()
    if case in ("window edges", "ties in several cells"):
        assert int((got[2] >= 0).sum()) > 0   # the case exercises matches at all


# ---------------------------------------------------------------------------
# keyframes and local mapping (plain PyTorch, no kernel of their own): the
# card runs them bit-identically from run to run and within the f32 spread
# of the CPU route (tests/test_torch_mapping.py states the bounds)
# ---------------------------------------------------------------------------


def _maps_identical(a, b):
    return [k for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


def _pose_err(a, b):
    from fishbirdeyevisualslam_torch.geometry import se3
    return se3.log(se3.compose(a.cpu(), se3.inverse(b.cpu()))).abs().max().item()


def test_bundle_adjust_card(dev):
    """Two card runs bit-identical; against the CPU: poses within 2e-4,
    points within 5e-3 m, the classification equal."""
    from fishbirdeyevisualslam_torch import convert
    from fishbirdeyevisualslam_torch.solvers import ba
    from torch_scenes import TCFG, ba_problem
    p = ba_problem()
    args = lambda d: (torch.from_numpy(p["poses0"]).to(d), torch.from_numpy(p["fixed"]).to(d),
                      convert.from_numpy(ba.PointBlocks, p["front"], d),
                      convert.from_numpy(ba.PointBlocks, p["bird"], d),
                      convert.from_numpy(ba.OdomEdges, p["odom"], d))
    r1, r2 = (ba.bundle_adjust(TCFG.camera, TCFG.ba, *args(dev)) for _ in range(2))
    assert _maps_identical(r1, r2) == []
    ref = ba.bundle_adjust(TCFG.camera, TCFG.ba, *args(torch.device("cpu")))
    assert _pose_err(r1.poses, ref.poses) < 2e-4
    torch.testing.assert_close(r1.front_Xw.cpu(), ref.front_Xw, rtol=0, atol=5e-3)
    torch.testing.assert_close(r1.bird_Xw.cpu(), ref.bird_Xw, rtol=0, atol=5e-3)
    assert torch.equal(r1.front_inlier.cpu(), ref.front_inlier)
    assert torch.equal(r1.bird_inlier.cpu(), ref.bird_inlier)


def test_reduced_solve_lu_branch_card(dev):
    """An indefinite reduced system: the Cholesky fails on the card too, and
    the LU solve of the same system is taken, with no host read."""
    from fishbirdeyevisualslam_torch.solvers import ba
    rng = np.random.RandomState(0)
    H = rng.randn(3, 6, 3, 6).astype(np.float32)
    Hcc = torch.from_numpy(H + H.transpose(2, 3, 0, 1)).to(dev)
    bc = torch.from_numpy(rng.randn(3, 6).astype(np.float32)).to(dev)
    fixed = torch.tensor([True, False, False], device=dev)
    Hd, b = ba._reduced_system(Hcc, bc, fixed, 1e-4)
    assert int(torch.linalg.cholesky_ex(Hd).info) > 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ba._solve_reduced(Hcc, bc, fixed, 1e-4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got.reshape(-1), torch.linalg.solve(Hd, b), rtol=1e-4, atol=1e-5)
    assert bool(torch.all(got[0] == 0))


def _tmap(d, dev):
    from fishbirdeyevisualslam_torch import convert
    return convert.map_state_from_numpy(d, dev)


def test_ties_card(dev):
    """The window and neighbour picks with tied covisibility weights: the
    same on the card as on the CPU, ties to the lower slot."""
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from torch_scenes import K, TCFG_TIES, ties_scene
    scene = ties_scene()
    for d in (dev, torch.device("cpu")):
        m = _tmap(scene, d)
        nb, ok = tr._top_covis_neighbors(m, 4, 3)
        assert nb.tolist() == [K - 1, 0, 1] and ok.tolist() == [True] * 3
        win = tr._local_window_masks(m, TCFG_TIES, 4)
        assert torch.nonzero(win[0]).flatten().tolist() == [0, 1, 4, K - 1]
        if d == dev:
            card = [x.cpu() for x in win]
    for x, y in zip(card, win):
        assert torch.equal(x, y)


def test_local_ba_ties_card(dev):
    """local_ba with tied weights and a live local keyframe in slot K-1: two
    card runs bit-identical, slot K-1 updated, the CPU within 2e-4."""
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from torch_scenes import K, TCFG_TIES, ties_scene
    scene = ties_scene()
    r1, r2 = (tr.local_ba(_tmap(scene, dev), TCFG_TIES, 4) for _ in range(2))
    assert _maps_identical(r1, r2) == []
    ref = tr.local_ba(_tmap(scene, "cpu"), TCFG_TIES, 4)
    assert set(_maps_identical(type(ref)(*[x.cpu() for x in r1]), ref)) <= {
        "kf_Tcw", "mp_pos", "bp_pos"}
    assert _pose_err(r1.kf_Tcw, ref.kf_Tcw) < 2e-4
    assert (r1.kf_Tcw[K - 1].cpu() != torch.from_numpy(scene["kf_Tcw"][K - 1])).any()


def test_local_mapping_step_card(dev):
    """insert_keyframe + local_mapping_step on the slice scene: two card runs
    bit-identical; against the CPU every discrete field equal, poses within
    2e-4, the points the new keyframe observes reprojected into it within
    0.02 px."""
    from fishbirdeyevisualslam_torch import convert
    from fishbirdeyevisualslam_torch.geometry import camera, se3
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from torch_scenes import TCFG, slice_scene
    s = slice_scene()

    def run(d):
        m = tr.insert_keyframe(_tmap(s["m"], d), convert.frame_from_numpy(s["frame"], d),
                               tr.TrackObs(torch.from_numpy(s["assoc"]["mp_idx"]).to(d),
                                           torch.from_numpy(s["assoc"]["bp_idx"]).to(d)),
                               torch.from_numpy(s["Tcw"]).to(d), TCFG, 15, slot=3, device=d)
        return tr.local_mapping_step(m, 3, TCFG, TCFG.tracking.mapping_neighbors, device=d)

    r1, r2 = run(dev), run(dev)
    assert _maps_identical(r1, r2) == []
    ref = run(torch.device("cpu"))
    got = type(ref)(*[x.cpu() for x in r1])
    floats = {"kf_Tcw", "mp_pos", "bp_pos", "mp_min_dist", "mp_max_dist", "mp_normal"}
    assert set(_maps_identical(got, ref)) <= floats
    assert _pose_err(got.kf_Tcw, ref.kf_Tcw) < 2e-4
    torch.testing.assert_close(got.bp_pos, ref.bp_pos, rtol=0, atol=5e-3)
    v = ref.mp_valid & torch.any((ref.obs_kf == 3) & ref.obs_valid, dim=1)
    uv = lambda m: camera.project_pinhole(TCFG.camera, se3.transform(ref.kf_Tcw[3], m.mp_pos[v]))
    assert (uv(got) - uv(ref)).abs().max().item() < 0.02


def test_patch_gather_init_budget(dev):
    """The gather at the initialization budget (n_features_init = 4096
    windows over a frame's front pyramid), which the facade's frames run
    until it initializes."""
    from scipy.ndimage import gaussian_filter
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.ops import features
    from fishbirdeyevisualslam_torch.ops import image as image_ops
    orb = SystemConfig().orb
    img = gaussian_filter(np.random.RandomState(0).rand(400, 950), 1.5)
    img = torch.from_numpy(((img - img.min()) / (img.max() - img.min()) * 255)
                           .astype(np.float32)).to(dev)
    levels = image_ops.build_pyramid(img, orb.n_levels, orb.scale_factor)
    maps = cuda_fast.fast_detect_levels(levels, float(orb.ini_th_fast), float(orb.min_th_fast))
    budgets = image_ops.per_level_budget(orb.n_features_init, orb.n_levels, orb.scale_factor)
    sels = [features._detect_level(s, r, orb, budgets[l]) for l, (s, r) in enumerate(maps)]
    atlas, yx = features.level_atlas(levels, [s[0] for s in sels])
    assert yx.shape[0] == orb.n_features_init
    n0 = cuda_patch.extract_patches.launches
    got = cuda_patch.extract_patches(atlas, yx, features.PATCH37)
    assert cuda_patch.extract_patches.launches == n0 + 1
    assert torch.equal(got, cuda_patch.extract_patches_plain(atlas, yx, features.PATCH37))


def test_facade_card(dev):
    """``SlamSystem.track`` over the first three frames of the arc drive on the
    card and on the CPU, with the same draws, at the system test's capacity
    (F=FB=512, an init budget of 1024): the same states, keyframes and
    initialization route; the init pair's poses within 1e-3 (se3 log), the
    tracked keyframe's within 1e-2 and the map's counts within max(5, 10%),
    the bounds of ``tests/test_torch_system.py`` for two facades whose frame
    builds differ in f32 rounding."""
    import dataclasses
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.io import synthetic
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    from torch_scenes import TCFG
    cfg = TCFG.replace(capacity=dataclasses.replace(TCFG.capacity, max_front_kp=512,
                                                    max_bird_kp=512),
                       orb=dataclasses.replace(TCFG.orb, n_features_init=1024))
    seq = synthetic.make_sequence(cfg, n_frames=3, kind="arc", step=0.5, seed=0)

    def run(d):
        s = SlamSystem(cfg, device=d)
        poses = np.stack([s.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i],
                                  fr["timestamp"]) for i, fr in enumerate(seq.frames)])
        return s, poses

    (card, p_card), (cpu, p_cpu) = run(dev), run("cpu")
    assert [e.state for e in card.trajectory] == [e.state for e in cpu.trajectory] == [0, 1, 1]
    np.testing.assert_array_equal(card.keyframe_indices(), cpu.keyframe_indices())
    assert card.inits[0]["route"] == cpu.inits[0]["route"]
    err = se3.log(se3.compose(torch.from_numpy(p_card), se3.inverse(torch.from_numpy(p_cpu))))
    err = err.abs().amax(-1)
    assert err[:2].max() <= 1e-3 and err[2] <= 1e-2, err
    for k in ("mp_valid", "bp_valid"):
        a, b = int(getattr(card.map, k).sum()), int(getattr(cpu.map, k).sum())
        assert abs(a - b) <= max(5, 0.1 * b), (k, a, b)


# ---------------------------------------------------------------------------
# relocalization and loop closing (plain PyTorch but for the pose kernel of
# compute_loop_transform's refinement): the card against the CPU route with
# the same draws (tests/test_torch_loop.py and test_torch_reloc.py hold the
# CPU route to the JAX package)
# ---------------------------------------------------------------------------


def _gumbel(seed, n):
    from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws
    return GumbelDraws(seed)(1, 128, n)[0]


def test_ransac_pnp_card(dev, monkeypatch):
    """150 points, 30 outliers: the same inliers on the card and the CPU, both
    within 0.05 of the truth, the poses within 1e-2 (se3 log).  EPnP puts
    its control points on the principal axes of the points, and
    ``torch.linalg.eigh`` fixes each axis up to its sign only: cuSOLVER and
    LAPACK choose other signs, so the two routes run EPnP on mirrored
    control points, which moves its pose within the noise
    (``scripts/pnp_card_vs_cpu.py``: 6.9e-3 here, 1.5e-3 to 8.2e-3 over
    seeds 9-13).  Given the card's signs, the CPU route gives the card's
    inliers and its pose within 6e-5 (measured 2.0e-5; 1.5e-5 to 3.0e-5
    over those seeds)."""
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import pnp
    from torch_scenes import TCFG, _project
    rng = np.random.RandomState(9)
    n = 150
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    T = se3.exp(torch.tensor([0.05, 0.1, -0.05, 0.3, -0.2, 0.5])).numpy()
    uv = (_project(T, Xw)[0] + rng.randn(n, 2) * 0.3).astype(np.float32)
    uv[:30] = rng.uniform(0, 900, (30, 2))
    g = _gumbel(0, n)
    eigh0, card_axes = torch.linalg.eigh, []

    def recorded(A):
        L, V = eigh0(A)
        card_axes.append(V.cpu())
        return L, V

    def card_signs(A):
        L, V = eigh0(A)
        s = torch.sign(torch.sum(V * card_axes.pop(0), dim=-2, keepdim=True))
        return L, V * torch.where(s == 0, 1.0, s)

    def run(d, eigh):
        monkeypatch.setattr(torch.linalg, "eigh", eigh)
        return pnp.ransac_pnp(TCFG.camera, torch.from_numpy(Xw).to(d),
                              torch.from_numpy(uv).to(d), torch.ones(n, dtype=torch.bool, device=d),
                              g.to(d))

    out = [run(dev, recorded), run(torch.device("cpu"), eigh0)]
    assert torch.equal(out[0].inliers.cpu(), out[1].inliers) and bool(out[0].success)
    assert _pose_err(out[0].Tcw, out[1].Tcw) < 1e-2
    assert max(_pose_err(o.Tcw, torch.from_numpy(T)) for o in out) < 0.05
    same = run(torch.device("cpu"), card_signs)
    assert not card_axes and torch.equal(same.inliers, out[1].inliers)
    err = _pose_err(out[0].Tcw, same.Tcw)
    assert err < 6e-5, err


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3_card(dev, fix_scale):
    from fishbirdeyevisualslam_torch.geometry import se3, sim3
    from fishbirdeyevisualslam_torch.solvers import sim3_solver
    rng = np.random.RandomState(7)
    n = 100
    p2 = (rng.randn(n, 3) * 5).astype(np.float32)
    T = se3.exp(torch.tensor([0.1, -0.3, 0.2, 1.5, -0.5, 0.8]))
    p1 = se3.transform(T, torch.from_numpy(p2)).numpy()
    p1[:30] += rng.uniform(2, 10, (30, 3))
    g = _gumbel(1, n)
    out = [sim3_solver.ransac_sim3(torch.from_numpy(p1).to(d), torch.from_numpy(p2).to(d),
                                   torch.ones(n, dtype=torch.bool, device=d), g.to(d),
                                   fix_scale=fix_scale)
           for d in (dev, torch.device("cpu"))]
    assert torch.equal(out[0].inliers.cpu(), out[1].inliers)
    assert not bool(out[1].inliers[:30].any()) and bool(out[1].success)
    assert _pose_err(sim3.to_se3(out[0].S12), sim3.to_se3(out[1].S12)) < 1e-4


def _loop_map(dev):
    from torch_scenes import loop_scene
    return _tmap(loop_scene()["m"], dev)


def test_compute_loop_transform_card(dev):
    """The loop scene's transform (cur 6, candidate 1): the same inliers and
    success, S within 1e-4 (se3 log); the card's refinement is one launch of
    the pose kernel."""
    from fishbirdeyevisualslam_torch.geometry import sim3
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    from torch_scenes import TCFG
    g = _gumbel(2, 512)
    n0 = cuda_pose_opt.pose_optimization.launches
    card = lc.compute_loop_transform(_loop_map(dev), 6, 1, TCFG, g.to(dev))
    assert cuda_pose_opt.pose_optimization.launches == n0 + 1
    cpu = lc.compute_loop_transform(_loop_map("cpu"), 6, 1, TCFG, g)
    assert int(card[1]) == int(cpu[1]) and bool(card[2]) == bool(cpu[2]) and bool(cpu[2])
    assert _pose_err(sim3.to_se3(card[0]), sim3.to_se3(cpu[0])) < 1e-4


def _close_loop(m, dev):
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc
    from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws
    from torch_scenes import TCFG
    closer = lc.LoopCloser(TCFG)
    closer.draws = GumbelDraws(3)
    closed = []
    for cur in (4, 5, 6):
        m, c = closer.process_keyframe(m, cur)
        closed.append(c)
    return m, closed


def test_loop_correction_card(dev):
    """``LoopCloser`` over the loop scene's return keyframes: two card runs
    bit-identical; against the CPU the same closure, every discrete field
    equal but the global BA's outlier flags (at most 0.1% differ), poses
    within 2e-4 and bird points within 5e-3 m."""
    (a, ca), (b, cb) = _close_loop(_loop_map(dev), dev), _close_loop(_loop_map(dev), dev)
    assert ca == cb == [False, False, True]
    assert _maps_identical(a, b) == []
    ref, cr = _close_loop(_loop_map("cpu"), "cpu")
    assert cr == ca
    got = type(ref)(*[x.cpu() for x in a])
    diff = set(_maps_identical(got, ref))
    assert diff <= {"kf_Tcw", "mp_pos", "bp_pos", "obs_valid", "bobs_valid"}, diff
    for k in ("obs_valid", "bobs_valid"):
        assert (getattr(got, k) != getattr(ref, k)).float().mean().item() <= 1e-3
    assert _pose_err(got.kf_Tcw[ref.kf_valid], ref.kf_Tcw[ref.kf_valid]) < 2e-4
    torch.testing.assert_close(got.bp_pos, ref.bp_pos, rtol=0, atol=5e-3)


def test_global_ba_card(dev):
    """The whole-map BA on the loop scene: two card runs bit-identical; the
    CPU within 1e-3 in poses (measured 3.8e-4: ten LM iterations over the
    drifted map) and 5e-3 m in bird points."""
    from fishbirdeyevisualslam_torch.slam import loop_closing as lc
    from torch_scenes import TCFG
    a, b = (lc.global_ba(_loop_map(dev), TCFG) for _ in range(2))
    assert _maps_identical(a, b) == []
    ref = lc.global_ba(_loop_map("cpu"), TCFG)
    got = type(ref)(*[x.cpu() for x in a])
    assert set(_maps_identical(got, ref)) <= {"kf_Tcw", "mp_pos", "bp_pos", "obs_valid",
                                              "bobs_valid"}
    assert _pose_err(got.kf_Tcw[ref.kf_valid], ref.kf_Tcw[ref.kf_valid]) < 1e-3
    torch.testing.assert_close(got.bp_pos, ref.bp_pos, rtol=0, atol=5e-3)


# ---------------------------------------------------------------------------
# asynchronous mapping: kernels on a second stream, the snapshot, the handoff
# ---------------------------------------------------------------------------


def test_kernels_on_a_side_stream(dev):
    """Kernels 4 and 5 launched under a side ``torch.cuda.Stream`` (as the
    mapping worker launches them) give results bit-identical to the same call
    on the default stream: every wrapper launches on the current stream."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    cfg = SystemConfig()
    prob = _problem(dev, 257, 2049, 5)
    T_true, front, bird = _pose_problem(dev, 2048, 2048, 12)
    T0 = se3.retract(T_true, torch.tensor([0.01, 0, -0.01, 0.05, 0.02, 0], device=dev))

    def run():
        return (cuda_matcher.fused_projection_match(*prob, max_dist=100.0, ratio=0.8),
                cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0, front, bird, T0, 100.0))

    main = run()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    n4, n5 = cuda_matcher.fused_projection_match.launches, cuda_pose_opt.pose_optimization.launches
    with torch.cuda.stream(side):
        other = run()
    side.synchronize()
    assert cuda_matcher.fused_projection_match.launches == n4 + 1
    assert cuda_pose_opt.pose_optimization.launches == n5 + 1
    for a, b in zip(main, other):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _async_cfg_and_drive():
    import dataclasses
    from fishbirdeyevisualslam_torch.io import synthetic
    from torch_scenes import TCFG
    cfg = TCFG.replace(capacity=dataclasses.replace(TCFG.capacity, max_front_kp=512,
                                                    max_bird_kp=512),
                       orb=dataclasses.replace(TCFG.orb, n_features_init=1024))
    return cfg, synthetic.make_sequence(cfg, n_frames=3, kind="arc", step=0.5, seed=0)


def _feed(s, seq, i, dt=0.0):
    fr = seq.frames[i]
    return s.track(fr["front"], fr["bird"], fr["mask"], seq.odom[i], fr["timestamp"] + dt)


def test_async_flushed_equals_sync_card(dev):
    """The system test's three frames on the card: the asynchronous facade,
    its pipeline flushed after each frame, equals the synchronous facade bit
    for bit (map, trajectory entries, export); its job ran on the mapping
    stream."""
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    cfg, seq = _async_cfg_and_drive()
    sync = SlamSystem(cfg, device=dev)
    for i in range(3):
        _feed(sync, seq, i)
    s = SlamSystem(cfg, device=dev, async_mapping=True)
    assert s._mapping_stream is not None
    try:
        for i in range(3):
            _feed(s, seq, i)
            s._pipeline.flush()
        s.finish()
        assert s.n_jobs_submitted == s.n_jobs_merged == 1
        assert _maps_identical(s.map, sync.map) == []
        for a, b in zip(s.trajectory, sync.trajectory):
            assert np.array_equal(a.T_rel, b.T_rel) and a.state == b.state
        assert np.array_equal(s.frame_trajectory_Twb(), sync.frame_trajectory_Twb())
    finally:
        s.close()


def test_async_snapshot_and_handoff_card(dev):
    """With the mapping stage held, tracking runs two frames on the live map
    while a job is in flight: every tensor of the job's snapshot is unchanged
    (compared with copies taken at the submit), the handoff in and out
    (``_submit_job`` with the stage held, ``_take_result``) makes no host
    sync under ``torch.cuda.set_sync_debug_mode("error")``, and the worker's
    own host syncs per job are counted and printed."""
    import threading
    import warnings
    from fishbirdeyevisualslam_torch.runtime.native import AsyncPipeline
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem
    cfg, seq = _async_cfg_and_drive()
    s = SlamSystem(cfg, device=dev, async_mapping=True)
    gate = threading.Event()
    stage, worker_syncs = s._mapping_stage, []

    def held(st, item):
        gate.wait(120)
        n = [0]
        me = threading.get_ident()

        def seen(message, *a, **k):
            if "synchroniz" in str(message) and threading.get_ident() == me:
                n[0] += 1

        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            try:
                stage(st, item)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        worker_syncs.append(n[0])

    s._pipeline.close()
    s._pipeline = AsyncPipeline([held], capacity=2)
    submit0, take0 = s._submit_job, s._take_result

    def strict(fn):
        def run(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    s._submit_job, s._take_result = strict(submit0), strict(take0)
    try:
        for i in range(3):
            _feed(s, seq, i)
        assert s.n_jobs_submitted == 1 and s._mapping_busy
        (job,) = s._mapping_jobs.values()
        before = [t.clone() for t in job.map]
        for k in (1, 2):
            _feed(s, seq, 2, 0.1 * k)
        torch.cuda.synchronize()
        assert [n for n, x, y in zip(job.map._fields, before, job.map)
                if not torch.equal(x, y)] == []
    finally:
        gate.set()
        s.finish()
        s.close()
    assert s.n_jobs_merged == 1 and s.n_frames_in_flight >= 2
    print(f"the worker's host syncs per job: {worker_syncs}")


# ---------------------------------------------------------------------------
# the edge filter, the bird odometer, the map fixture, the contour mask
# ---------------------------------------------------------------------------


def _bird_drive(n=8):
    """``tests/test_bird_odometer.py``'s drive: world 4, straight, 0.3 m a frame."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.io import synthetic
    cfg = SystemConfig()
    world = synthetic.make_world(4)
    out = []
    for p in synthetic.make_trajectory(n, kind="straight", step=0.3):
        bird = synthetic.render_bird(world, cfg, p)
        mask, _ = synthetic.bird_mask_and_contour(cfg, bird)
        out.append((bird.astype(np.float32), mask.astype(np.float32)))
    return cfg, out


def test_filter_ipm_edges_card_equals_cpu(dev):
    """The whole ``EdgeFilterIPM`` pipeline on the card: every output equal
    to the CPU route's, on two bird renders and their freespace; no host
    read inside."""
    from fishbirdeyevisualslam_torch.ops.edge_filter import filter_ipm_edges
    _, drive = _bird_drive(2)
    for bird, mask in drive:
        b, f = torch.from_numpy(bird), torch.from_numpy(mask * 255.0)
        want = filter_ipm_edges(b, f)
        bd, fd = b.to(dev), f.to(dev)
        filter_ipm_edges(bd, fd)        # the first call copies its constant tables
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = filter_ipm_edges(bd, fd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert int(want[1].sum()) > 50


@pytest.mark.parametrize("method,edge_filter", [("ndt", False), ("icp", False), ("ndt", True)])
def test_bird_odometer_card_equals_cpu(dev, method, edge_filter):
    """``BirdOdometer`` over the 8-frame drive on the card and on the CPU:
    poses within 1e-4 m (the card's scatter-adds and reductions sum in
    another order); each step after the first within 0.12 m of 0.3 m."""
    from fishbirdeyevisualslam_torch.slam.bird_odometer import BirdOdometer
    cfg, drive = _bird_drive()
    poses = {}
    for d in (dev, torch.device("cpu")):
        odo = BirdOdometer(cfg, method=method, use_edge_filter=edge_filter, device=d)
        poses[d.type] = np.stack([odo.add_new_frame(b, m) for b, m in drive])
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-4)
    step = np.linalg.norm(np.diff(poses["cuda"][:, :2], axis=0), axis=1)
    assert np.all(np.abs(step[1:] - 0.3) < 0.12), step


def test_make_realistic_map_on_card(dev):
    """The default capacities (K = 256, P = 32768, PB = 16384) built on the
    card: integer fields equal to the CPU build, floats within 1e-6
    relative, every tensor on the card."""
    import time
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.convert import map_state_to_numpy
    from fishbirdeyevisualslam_torch.io.fixtures import make_realistic_map
    cfg = SystemConfig()
    t0 = time.perf_counter()
    m = make_realistic_map(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(x.device.type == "cuda" for x in m)
    assert m.kf_Tcw.shape[0] == 256 and m.mp_pos.shape[0] == 32768 and m.bp_pos.shape[0] == 16384
    got, want = map_state_to_numpy(m), map_state_to_numpy(make_realistic_map(cfg, 0, "cpu"))
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    print(f"make_realistic_map at the default capacities on the card: {dt:.2f} s")


def test_degraded_frame_with_contour(dev):
    """One degraded frame through ``build_frame`` with its contour, on the
    card and on the CPU: the detection mask equal, every valid bird keypoint
    on it, fewer bird keypoints than without the contour, and the two
    devices' keypoint sets equal to >= 97%, with and without the contour.
    The pyramid's float32 products sum in another order on the card, so a
    corner's score can move in its last bits and trade places in the top-k
    (measured: 98.75% of the 1437 bird keypoints equal with the contour)."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.io import synthetic
    from fishbirdeyevisualslam_torch.slam.frame import bird_detection_mask, build_frame
    cfg = SystemConfig()
    seq = synthetic.make_sequence(cfg, n_frames=2, kind="arc", step=0.5,
                                  degrade=synthetic.DegradeConfig())
    fr = seq.frames[1]
    n = cfg.capacity.max_front_kp
    frames = {d: build_frame(fr["front"], fr["bird"], fr["mask"], seq.odom[1], fr["timestamp"],
                             cfg, n, contour=fr["contour"], device=d) for d in ("cuda", "cpu")}
    bare = build_frame(fr["front"], fr["bird"], fr["mask"], seq.odom[1], fr["timestamp"], cfg, n,
                       device=dev)
    mask = bird_detection_mask(torch.from_numpy(fr["mask"].astype(np.float32)),
                               torch.from_numpy(fr["contour"].astype(np.float32)))
    mask_card = bird_detection_mask(torch.from_numpy(fr["mask"].astype(np.float32)).to(dev),
                                    torch.from_numpy(fr["contour"].astype(np.float32)).to(dev))
    assert torch.equal(mask_card.cpu(), mask)
    f, c = frames["cuda"], frames["cpu"]
    ok = f.bird_kp_valid.cpu()
    uv = f.bird_uv.cpu()[ok].round().long()
    assert mask[uv[:, 1], uv[:, 0]].float().mean() >= 0.95   # pyramid levels round off it
    assert 100 < int(ok.sum()) < int(bare.bird_kp_valid.sum())
    bare_cpu = build_frame(fr["front"], fr["bird"], fr["mask"], seq.odom[1], fr["timestamp"], cfg,
                           n, device="cpu")
    for name, a, b, va, vb in (
            ("bird", f.bird_uv, c.bird_uv, f.bird_kp_valid, c.bird_kp_valid),
            ("front", f.uv_raw, c.uv_raw, f.kp_valid, c.kp_valid),
            ("bird without the contour", bare.bird_uv, bare_cpu.bird_uv, bare.bird_kp_valid,
             bare_cpu.bird_kp_valid)):
        ka = {tuple(x) for x in a.cpu()[va.cpu()].tolist()}
        kb = {tuple(x) for x in b[vb].tolist()}
        share = len(ka & kb) / max(len(ka), 1)
        print(f"{name}: {len(ka)} keypoints on the card, {len(kb)} on the CPU, "
              f"{share:.4f} of the card's among the CPU's")
        assert share >= 0.97, name


@pytest.mark.parametrize("B,n,nb", [(16, 2048, 2048), (3, 300, 80), (5, 6000, 4000)])
def test_pose_optimization_batched(dev, B, n, nb):
    """One launch over B problems (a cluster each) bit-identical to B single
    launches, row by row, and each row within the single kernel's bounds of
    its plain version (pose 1e-3, inlier flips under 2%, n_inliers within 5);
    rows 6000 + 4000 go past the cluster's registers."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.geometry import se3
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs
    cfg = SystemConfig()
    probs = [_pose_problem(dev, n, nb, 100 + b) for b in range(B)]
    T0 = torch.stack([se3.retract(p[0], torch.tensor([0.01, 0, -0.01, 0.05, 0.02 * b, 0],
                                                     device=dev)) for b, p in enumerate(probs)])
    front = FrontObs(*(torch.stack(x) for x in zip(*(p[1] for p in probs))))
    bird = BirdObs(*(torch.stack(x) for x in zip(*(p[2] for p in probs))))
    n0 = cuda_pose_opt.pose_optimization_batched.launches
    got = cuda_pose_opt.pose_optimization_batched(cfg.camera, cfg.ba, T0, front, bird, T0, 100.0)
    assert cuda_pose_opt.pose_optimization_batched.launches == n0 + 1
    assert got.Tcw.shape == (B, 7) and got.n_inliers.shape == (B,)
    for b, (_, fo, bo) in enumerate(probs):
        one = cuda_pose_opt.pose_optimization(cfg.camera, cfg.ba, T0[b], fo, bo, T0[b], 100.0)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)
        ref = cuda_pose_opt.pose_optimization_plain(cfg.camera, cfg.ba, T0[b], fo, bo, T0[b],
                                                    100.0)
        assert _pose_err(got.Tcw[b], ref.Tcw) < 1e-3
        assert _flips(got.front_inlier[b], ref.front_inlier) < 0.02
        assert _flips(got.bird_inlier[b], ref.bird_inlier) < 0.02
        assert abs(int(got.n_inliers[b]) - int(ref.n_inliers)) <= 5


def test_distributed_ba_world_size_1_nccl(dev, tmp_path):
    """``distributed_bundle_adjust`` over a one-rank NCCL group bit-identical
    to ``bundle_adjust`` on ``torch_scenes.ba_problem``."""
    import torch.distributed as dist
    from fishbirdeyevisualslam_torch import convert
    from fishbirdeyevisualslam_torch.parallel import sharded_ba
    from fishbirdeyevisualslam_torch.solvers import ba
    from torch_scenes import TCFG, ba_problem
    p = ba_problem()
    args = (torch.from_numpy(p["poses0"]).to(dev), torch.from_numpy(p["fixed"]).to(dev),
            convert.from_numpy(ba.PointBlocks, p["front"], dev),
            convert.from_numpy(ba.PointBlocks, p["bird"], dev),
            convert.from_numpy(ba.OdomEdges, p["odom"], dev))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = sharded_ba.make_mesh(device=dev)
        got = sharded_ba.distributed_bundle_adjust(TCFG, mesh, *args, n_iters_1=5, n_iters_2=5)
    finally:
        dist.destroy_process_group()
    want = ba.bundle_adjust(TCFG.camera, TCFG.ba, *args, n_iters_1=5, n_iters_2=5)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_match_map_points_dual_card(dev):
    """The mask form on the card (compacted ids, kernel 3) equal to the CPU's
    plain matcher on ``torch_scenes.slice_scene``, under both routes of the
    compaction."""
    import dataclasses
    from fishbirdeyevisualslam_torch import convert
    from fishbirdeyevisualslam_torch.ops import cuda_matcher
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from torch_scenes import TCFG, slice_scene
    s = slice_scene()
    cand = s["m"]["mp_valid"] & (np.random.RandomState(0).rand(s["m"]["mp_valid"].shape[0])
                                 < 0.7)
    th = float(TCFG.matcher.th_high)

    def run(d, cfg):
        return tr.match_map_points_dual(convert.map_state_from_numpy(s["m"], d),
                                        convert.frame_from_numpy(s["frame"], d), cfg,
                                        torch.from_numpy(s["Tcw"]).float().to(d),
                                        torch.from_numpy(cand).to(d), 15.0, th)

    want = run(torch.device("cpu"), TCFG)
    for cap in (TCFG.tracking.match_compact_cap, 16):
        cfg = TCFG.replace(tracking=dataclasses.replace(TCFG.tracking, match_compact_cap=cap))
        n0 = cuda_matcher.fused_projection_match_dual.launches
        got = run(dev, cfg)
        assert cuda_matcher.fused_projection_match_dual.launches == n0 + 1
        for r, w in zip(got, want):
            assert all(torch.equal(x.cpu(), y) for x, y in zip(r, w))


def test_extract_card(dev):
    """``extract`` on the card: the front view of ``extract_dual`` exactly,
    and the bird view with its detection mask."""
    from scipy.ndimage import gaussian_filter
    from fishbirdeyevisualslam_torch.config import OrbConfig
    from fishbirdeyevisualslam_torch.ops import features
    rng = np.random.RandomState(2)
    imgs = []
    for shape in ((400, 950), (384, 384)):
        img = gaussian_filter(rng.rand(*shape), 1.5)
        imgs.append(torch.from_numpy(((img - img.min()) / (img.max() - img.min()) * 255)
                                     .astype(np.float32)).to(dev))
    mask = torch.ones(384, 384, dtype=torch.bool, device=dev)
    mask[:40] = False
    orb = OrbConfig()
    dual = features.extract_dual(imgs[0], imgs[1], orb, 2048, 2048, mask_b=mask)
    n0 = (cuda_fast.fast_detect_levels.launches, cuda_patch.extract_patches.launches)
    one = (features.extract(imgs[0], orb, 2048),
           features.extract(imgs[1], orb, 2048, detection_mask=mask))
    assert (cuda_fast.fast_detect_levels.launches, cuda_patch.extract_patches.launches) \
        == (n0[0] + 2, n0[1] + 2)
    for a, b in zip(one, dual):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
