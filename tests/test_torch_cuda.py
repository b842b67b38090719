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
