"""Parity of the port's matchers with the JAX package: the projection
matchers' plain versions (the reference the CUDA kernels are held to) against
the JAX package's dense ``matcher.match`` reference on the same problems,
idx / ok / dist exactly; duplicate resolution and its tie order; and the
fused-matcher route of the tracking core (candidate compaction) against its
dense route.  The JAX side of every case is computed once per run
(``torch_refs.shared``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.ops import matcher as j_matcher
from fishbirdeyevisualslam_torch.config import CapacityConfig, SystemConfig
from fishbirdeyevisualslam_torch.ops import cuda_matcher, matcher
from fishbirdeyevisualslam_torch.ops import orb as t_orb
from fishbirdeyevisualslam_torch.slam import map_state as ms
from fishbirdeyevisualslam_torch.slam import tracking as tr
from fishbirdeyevisualslam_torch.slam.frame import Frame

import torch_refs

torch.set_num_threads(1)


def _pm1(words):
    bits = ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(len(words), 256)
    return (bits.astype(np.float32) * 2 - 1)


def make_problem(na=300, nb=700, seed=0):
    """``tests/test_fused_projection_match.py:make_problem`` in numpy: b rows
    0..na-1 are a rows with a few flipped bits, so real matches exist."""
    rng = np.random.RandomState(seed)
    bits_a = rng.randint(0, 2**32, (na, 8), dtype=np.uint64).astype(np.uint32)
    bits_b = rng.randint(0, 2**32, (nb, 8), dtype=np.uint64).astype(np.uint32)
    bits_b[:na] = bits_a
    flip = rng.randint(0, 2**32, (na, 8), dtype=np.uint64).astype(np.uint32)
    bits_b[:na] ^= flip & rng.randint(0, 2, (na, 8)).astype(np.uint32)
    uv_a = rng.uniform(0, 900, (na, 2)).astype(np.float32)
    uv_b = np.concatenate([uv_a + rng.randn(na, 2).astype(np.float32) * 3,
                           rng.uniform(0, 900, (nb - na, 2)).astype(np.float32)])
    oct_a = rng.randint(0, 8, na).astype(np.int32)
    pred_b = rng.randint(0, 8, nb).astype(np.float32)
    valid_a = rng.rand(na) > 0.1
    valid_b = rng.rand(nb) > 0.1
    radius_b = rng.uniform(5, 40, nb).astype(np.float32)
    return (_pm1(bits_a), uv_a, oct_a, valid_a, _pm1(bits_b), uv_b, radius_b, pred_b, valid_b)


def jax_dense(prob, max_dist, level_window, ratio=None, scale=1.0):
    """The JAX package's dense reference (test_fused_projection_match.py:39-47)."""
    pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b, valid_b = map(jnp.asarray, prob)
    radius_b = radius_b * scale
    d_uv = jnp.abs(uv_a[:, None, :] - uv_b[None, :, :])
    compat = (d_uv[..., 0] <= radius_b[None, :]) & (d_uv[..., 1] <= radius_b[None, :])
    if level_window:
        d_oct = oct_a[:, None].astype(jnp.float32) - pred_b[None, :]
        compat = compat & (d_oct >= -1) & (d_oct <= 1)
    compat = compat & valid_a[:, None] & valid_b[None, :]
    return j_matcher.match(pm1_a.astype(jnp.bfloat16), pm1_b.astype(jnp.bfloat16), compat,
                           max_dist=max_dist, ratio=ratio)


def to_torch(prob):
    t = [torch.from_numpy(np.array(x)) for x in prob]
    t[0] = t[0].to(torch.bfloat16)
    t[4] = t[4].to(torch.bfloat16)
    return t


def assert_same(res, ref):
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(ref.dist))


def _ties_case():
    rng = np.random.RandomState(2)
    a = np.where(rng.rand(40, 256) > 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(120, 256) > 0.5, 1.0, -1.0).astype(np.float32)
    b[10:50] = a      # exact copies ...
    b[80:120] = a     # ... twice, at higher columns
    b[60:100:3] = -b[60:100:3]
    compat = rng.rand(40, 120) > 0.2
    return a, b, compat


def _duplicates_case(seed):
    rng = np.random.RandomState(seed)
    n_a, n_b = 200, 16
    idx = rng.randint(0, n_b, n_a).astype(np.int32)
    dist = rng.randint(0, 4, n_a).astype(np.float32)
    ok = rng.rand(n_a) > 0.2
    idx = np.where(ok, idx, -1).astype(np.int32)
    dist = np.where(ok, dist, 1e9).astype(np.float32)
    return idx, dist, ok, n_b


def _window_case():
    rng = np.random.RandomState(3)
    xa = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    xb = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    return rng, xa, xb


def _negative_pred_problem():
    prob = list(make_problem(seed=7))
    prob[7] = np.full_like(prob[7], -1.0)
    return prob


def _jax_refs():
    """The JAX package's results for every case of this module, as numpy."""
    refs = {}
    for seed in (0, 1):
        for lw in (False, True):
            for ratio in (None, 0.8):
                refs["single", lw, ratio, seed] = jax_dense(make_problem(seed=seed), 60.0, lw,
                                                            ratio)
    for seed in (4, 5):
        for lw in (False, True):
            refs["dual", lw, seed] = [jax_dense(make_problem(seed=seed), 60.0, lw, scale=scale)
                                      for scale in (1.0, 2.0)]
    refs["negative pred"] = jax_dense(_negative_pred_problem(), 60.0, level_window=False)
    a, b, compat = _ties_case()
    for ratio in (None, 0.95):
        refs["ties", ratio] = j_matcher.match(jnp.asarray(a, jnp.bfloat16),
                                              jnp.asarray(b, jnp.bfloat16), jnp.asarray(compat),
                                              max_dist=100.0, ratio=ratio)
    for seed in (0, 1, 2):
        idx, dist, ok, n_b = _duplicates_case(seed)
        refs["duplicates", seed] = j_matcher.resolve_duplicates(
            j_matcher.MatchResult(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(ok)), n_b)
    _, xa, xb = _window_case()
    refs["window"] = j_matcher.window_mask(jnp.asarray(xa), jnp.asarray(xb), 20.0)
    return {k: jax.tree.map(np.asarray, v) for k, v in refs.items()}


torch_refs.register("torch_match_jax", __file__, _jax_refs)


@pytest.fixture(scope="module")
def jax_refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_match_jax")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("level_window", [False, True])
@pytest.mark.parametrize("ratio", [None, 0.8])
def test_projection_match_plain(jax_refs, level_window, ratio, seed):
    prob = make_problem(seed=seed)
    ref = jax_refs["single", level_window, ratio, seed]
    res = cuda_matcher.fused_projection_match(*to_torch(prob), max_dist=60.0,
                                              level_window=level_window, ratio=ratio)
    assert int(res.count) > 50
    assert_same(res, ref)


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("level_window", [False, True])
def test_projection_match_dual_plain(jax_refs, level_window, seed):
    prob = make_problem(seed=seed)
    res1, res2 = cuda_matcher.fused_projection_match_dual(
        *to_torch(prob), max_dist=60.0, r2_scale=2.0, level_window=level_window)
    for res, ref in zip((res1, res2), jax_refs["dual", level_window, seed]):
        assert_same(res, ref)


def test_negative_pred_disables_octave_gate(jax_refs):
    gated = cuda_matcher.fused_projection_match(*to_torch(_negative_pred_problem()),
                                                max_dist=60.0, level_window=True)
    assert_same(gated, jax_refs["negative pred"])


@pytest.mark.parametrize("ratio", [None, 0.95])
def test_match_ties_go_to_lowest_column(jax_refs, ratio):
    """Equal best distances pick the lowest column; the second-best may equal
    the best (so a ratio test rejects exact duplicates), as in the JAX package."""
    a, b, compat = _ties_case()
    res = matcher.match(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                        torch.from_numpy(compat), max_dist=100.0, ratio=ratio)
    assert_same(res, jax_refs["ties", ratio])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_duplicates_lowest_row(jax_refs, seed):
    """Many rows on few columns with tied distances: the closest survives,
    equal distances going to the lowest row."""
    idx, dist, ok, n_b = _duplicates_case(seed)
    res = matcher.resolve_duplicates(
        matcher.MatchResult(torch.from_numpy(idx), torch.from_numpy(dist), torch.from_numpy(ok)),
        n_b)
    assert_same(res, jax_refs["duplicates", seed])


def test_window_mask_and_hamming(jax_refs):
    rng, xa, xb = _window_case()
    np.testing.assert_array_equal(
        matcher.window_mask(torch.from_numpy(xa), torch.from_numpy(xb), 20.0).numpy(),
        jax_refs["window"])
    a, b = _pm1(rng.randint(0, 2**32, (30, 8), dtype=np.uint64).astype(np.uint32)), \
        _pm1(rng.randint(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32))
    ham = t_orb.hamming_matrix(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    np.testing.assert_array_equal(ham.numpy(), 0.5 * (256 - a @ b.T))


# --- the fused-matcher route of the tracking core, on CPU tensors -----------


def _route_problem(seed, n_pts=600):
    """A small map whose points project near a frame's keypoints."""
    rng = np.random.RandomState(seed)
    cap = CapacityConfig(max_keyframes=8, max_points=1024, max_bird_points=512,
                         max_obs_per_point=4, max_front_kp=256, max_bird_kp=128)
    cfg = SystemConfig(capacity=cap)
    m = ms.empty_map(cfg, device="cpu")
    F, FB = 256, 128
    uv = np.stack([rng.uniform(20, 930, F), rng.uniform(20, 380, F)], -1).astype(np.float32)
    words = rng.randint(0, 2**32, (F, 8), dtype=np.uint64).astype(np.uint32)
    pm1 = _pm1(words)
    z = rng.uniform(5, 30, n_pts).astype(np.float32)
    src = rng.randint(0, F, n_pts)
    c = cfg.camera
    uvp = uv[src] + rng.randn(n_pts, 2).astype(np.float32) * 4
    pos = np.stack([(uvp[:, 0] - c.cx) * z / c.fx, (uvp[:, 1] - c.cy) * z / c.fy, z], -1)
    mp_pm1 = pm1[src] * np.where(rng.rand(n_pts, 256) < 0.05, -1, 1)
    P = cap.max_points
    m = m._replace(
        mp_pos=m.mp_pos.index_put((torch.arange(n_pts),), torch.from_numpy(pos.astype(np.float32))),
        mp_desc_pm1=m.mp_desc_pm1.index_put((torch.arange(n_pts),),
                                            torch.from_numpy(mp_pm1.astype(np.float32)).bfloat16()),
        mp_valid=torch.arange(P) < n_pts,
        mp_max_dist=torch.where(torch.arange(P) < n_pts // 2, torch.tensor(40.0), m.mp_max_dist),
        mp_min_dist=torch.full((P,), 0.5),
    )
    f = Frame(uv_raw=torch.from_numpy(uv), uv=torch.from_numpy(uv),
              octave=torch.from_numpy(rng.randint(0, 3, F).astype(np.int32)),
              angle=torch.zeros(F), desc=torch.from_numpy(words.view(np.int32)),
              desc_pm1=torch.from_numpy(pm1).bfloat16(), kp_valid=torch.rand(F) > 0.05,
              bird_uv=torch.zeros(FB, 2), bird_octave=torch.zeros(FB, dtype=torch.int32),
              bird_desc=torch.zeros(FB, 8, dtype=torch.int32),
              bird_desc_pm1=torch.zeros(FB, 256, dtype=torch.bfloat16),
              bird_kp_valid=torch.zeros(FB, dtype=torch.bool), bird_base=torch.zeros(FB, 3),
              bird_cam=torch.zeros(FB, 3), odom=torch.zeros(3), timestamp=torch.zeros(()))
    return cfg, m, f


@pytest.mark.parametrize("compact_cap", [4096, 512, 64])
def test_local_match_fused_route_equals_dense(compact_cap):
    """Compacted (cap fits), full-axis (cap overflows) and dense routes agree."""
    cfg, m, f = _route_problem(0)
    cfg = cfg.replace(tracking=type(cfg.tracking)(local_match_compact_cap=compact_cap))
    T = torch.tensor([1.0, 0, 0, 0, 0.01, -0.02, 0.03])
    cand = torch.rand(m.mp_pos.shape[0], generator=torch.Generator().manual_seed(0)) > 0.3
    dense, vis_d = tr.match_map_points(m, f, cfg, T, cand, 12.0, 100.0, True, fused=False)
    fused, vis_f = tr.match_map_points(m, f, cfg, T, cand, 12.0, 100.0, True, fused=True)
    assert int(dense.count) > 20
    torch.testing.assert_close(fused, dense, rtol=0, atol=0)
    assert torch.equal(vis_d, vis_f)


def test_motion_match_fused_route_equals_dense():
    cfg, m, f = _route_problem(1)
    T = torch.tensor([1.0, 0, 0, 0, -0.01, 0.02, 0.0])
    ids = torch.full((700,), -1, dtype=torch.int32)
    ids[::2] = torch.randperm(600, generator=torch.Generator().manual_seed(1))[:350].int()
    dense = tr.match_map_points_dual_ids(m, f, cfg, T, ids, 15.0, 100.0, fused=False)
    fused = tr.match_map_points_dual_ids(m, f, cfg, T, ids, 15.0, 100.0, fused=True)
    assert int(dense[0].count) > 20
    for a, b in zip(fused, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
