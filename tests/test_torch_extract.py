"""Parity of the port's extraction (pyramid, FAST, patch gather, orientation,
rBRIEF, extract_dual) with the JAX package on the same numpy inputs.  FAST
and the patch gather are compared through their plain versions, against the
references the JAX package holds its Pallas kernels to (``fast_ops.detect``
and ``vmap(lax.dynamic_slice)``).  The JAX side of every case is computed
once per run (``torch_refs.shared``)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from fishbirdeyevisualslam_tpu.config import OrbConfig as JaxOrb
from fishbirdeyevisualslam_tpu.ops import fast as j_fast
from fishbirdeyevisualslam_tpu.ops import features as j_feat
from fishbirdeyevisualslam_tpu.ops import image as j_image
from fishbirdeyevisualslam_tpu.ops import orb as j_orb
from fishbirdeyevisualslam_torch.config import OrbConfig
from fishbirdeyevisualslam_torch.ops import cuda_fast, cuda_patch
from fishbirdeyevisualslam_torch.ops import features as t_feat
from fishbirdeyevisualslam_torch.ops import image as t_image
from fishbirdeyevisualslam_torch.ops import orb as t_orb

import torch_refs

torch.set_num_threads(1)

# the references are compiled with XLA's backend at optimisation level 0: the
# same programs, with about half the compile's CPU time
XLA_OPTS = {"xla_backend_optimization_level": 0}

FRONT, BIRD = (400, 950), (384, 384)


def _image(shape, seed, sigma=1.5):
    rng = np.random.RandomState(seed)
    img = gaussian_filter(rng.rand(*shape), sigma)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def _level_pairs():
    pairs = []
    for h, w in (FRONT, BIRD):
        for lh, lw in t_image.pyramid_shapes(h, w, 8, 1.2)[1:]:
            pairs += [(h, lh), (w, lw)]
    return sorted(set(pairs))


FAST_SHAPES = [(64, 128), (100, 200), (57, 131)]
PATCH_CASES = [(100, 37), (257, 37), (64, 9)]
SELECT_CASES = [((112, 265), 128), ((107, 107), 150), ((400, 950), 460)]


def _fast_image(shape):
    return np.random.RandomState(3).rand(*shape).astype(np.float32) * 255


def _patch_case(n, side):
    rng = np.random.RandomState(n)
    img = rng.rand(300, 420).astype(np.float32)
    yx = np.stack([rng.randint(-5, 300 - side + 6, n), rng.randint(-5, 420 - side + 6, n)],
                  -1).astype(np.int32)
    return img, yx


def _patches(seed, n=300):
    """(n, 37, 37) windows of a smooth image, like the patches around corners
    (uniform noise patches have near-zero moments and an ill-defined angle)."""
    img = _image(FRONT, seed)
    rng = np.random.RandomState(seed)
    ys, xs = rng.randint(0, FRONT[0] - 37, n), rng.randint(0, FRONT[1] - 37, n)
    return np.stack([img[y:y + 37, x:x + 37] for y, x in zip(ys, xs)])


def _descriptor_case(seed):
    rng = np.random.RandomState(seed)
    blurred = (rng.rand(300, 31, 31) * 255).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    return blurred, ang


def _bits(seed):
    bits = (np.random.RandomState(seed).rand(64, 256) > 0.5).astype(np.uint8)
    bits[0] = 1
    return bits


def _tied_scores():
    return np.random.RandomState(0).randint(0, 4, 500).astype(np.float32)


def _grid_scores(shape):
    rng = np.random.RandomState(1)
    return (rng.randint(0, 6, shape) * (rng.rand(*shape) > 0.7)).astype(np.float32)


def _jax_refs():
    """The JAX package's results for the small cases of this module, as numpy."""
    refs = {}
    for n_in, n_out in _level_pairs():
        refs["resize", n_in, n_out] = jax.image.resize(jnp.eye(n_in, dtype=jnp.float32),
                                                       (n_in, n_out), "linear")
    for shape in (FRONT, BIRD):
        refs["pyramid", shape] = j_image.build_pyramid(jnp.asarray(_image(shape, 1)), 8, 1.2)
    detect = jax.jit(j_fast.detect, static_argnums=(1, 2, 3), compiler_options=XLA_OPTS)
    for shape in FAST_SHAPES:
        refs["fast", shape] = detect(jnp.asarray(_fast_image(shape)), 15.0, 5.0, True)
    for n, side in PATCH_CASES:
        img, yx = _patch_case(n, side)
        refs["patch", n, side] = jax.vmap(lambda p: jax.lax.dynamic_slice(
            jnp.asarray(img), (p[0], p[1]), (side, side)))(jnp.asarray(yx))
    for seed in (0, 1):
        p = _patches(seed)
        refs["orientations", seed] = j_orb.orientations(jnp.asarray(p[:, 3:34, 3:34]))
        refs["blur", seed] = j_feat._blur_patches(jnp.asarray(p))
        blurred, ang = _descriptor_case(seed)
        refs["descriptors", seed] = j_orb.descriptors(jnp.asarray(blurred), jnp.asarray(ang),
                                                      use_matmul=False)
        bits = jnp.asarray(_bits(seed))
        refs["pack", seed] = (j_orb.pack_bits(bits), j_orb.bits_to_pm1(bits))
    refs["top_k"] = jax.lax.top_k(jnp.asarray(_tied_scores()), 120)
    select = jax.jit(j_feat._select_grid_topk, static_argnums=(1, 2, 3),
                     compiler_options=XLA_OPTS)
    for shape, n_out in SELECT_CASES:
        refs["select", shape, n_out] = select(jnp.asarray(_grid_scores(shape)), n_out, 32, 16)
    return {k: jax.tree.map(np.asarray, v) for k, v in refs.items()}


torch_refs.register("torch_extract_jax", __file__, _jax_refs)


@pytest.fixture(scope="module")
def jax_refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_extract_jax")


@pytest.mark.parametrize("n_in,n_out", _level_pairs())
def test_resize_weights_match_jax(jax_refs, n_in, n_out):
    """The per-axis weights equal those ``jax.image.resize`` applies under jit."""
    ref = jax_refs["resize", n_in, n_out]
    np.testing.assert_allclose(t_image.resize_weights(n_in, n_out), ref, atol=1e-6)


@pytest.mark.parametrize("shape", [FRONT, BIRD])
def test_pyramid_matches_jax(jax_refs, shape):
    img = _image(shape, 1)
    pj = jax_refs["pyramid", shape]
    pt = t_image.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for a, b in zip(pj, pt):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


def test_per_level_budget_matches_jax():
    for n in (256, 2000, 2048, 4096):
        assert t_image.per_level_budget(n, 8, 1.2) == j_image.per_level_budget(n, 8, 1.2)


@pytest.mark.parametrize("shape", FAST_SHAPES)
def test_fast_plain_matches_jax(jax_refs, shape):
    """The FAST kernel's plain version against ``fast_ops.detect`` at the
    tolerance the JAX package holds its Pallas kernel to."""
    img = _fast_image(shape)
    ref_score, ref_raw = jax_refs["fast", shape]
    (score, raw), = cuda_fast.fast_detect_levels([torch.from_numpy(img)], 15.0, 5.0)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref_raw), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,side", PATCH_CASES)
def test_patch_gather_exact(jax_refs, n, side):
    """The patch gather's plain version equals ``vmap(lax.dynamic_slice)``,
    start clamping at the borders included."""
    img, yx = _patch_case(n, side)
    ref = jax_refs["patch", n, side]
    got = cuda_patch.extract_patches(torch.from_numpy(img), torch.from_numpy(yx), side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_orientations(jax_refs, seed):
    p = _patches(seed)[:, 3:34, 3:34]
    np.testing.assert_allclose(t_orb.orientations(torch.from_numpy(p)).numpy(),
                               jax_refs["orientations", seed], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_blur_patches(jax_refs, seed):
    p = _patches(seed)
    np.testing.assert_allclose(t_feat._blur_patches(torch.from_numpy(p)).numpy(),
                               jax_refs["blur", seed], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_descriptor_bits_equal(jax_refs, seed):
    """The gather sampler gives the same bits on the same blurred patches and angles."""
    blurred, ang = _descriptor_case(seed)
    ref = jax_refs["descriptors", seed]
    got = t_orb.descriptors(torch.from_numpy(blurred), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_brief_tables_match_jax():
    for a, b in zip(t_orb._binned_sample_tables(32), j_orb._binned_sample_tables(32)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_orb.brief_pattern(), j_orb.brief_pattern())


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_bits(jax_refs, seed):
    """Packed words carry the JAX package's uint32 bits, sign bit included."""
    bits = _bits(seed)
    ref, ref_pm1 = jax_refs["pack", seed]
    packed = t_orb.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(t_orb.unpack_bits(packed).numpy(), bits)
    np.testing.assert_array_equal(
        t_orb.bits_to_pm1(torch.from_numpy(bits)).float().numpy(),
        ref_pm1.astype(np.float32))


def test_stable_topk_tie_order(jax_refs):
    """Ties go to the lower index, as ``lax.top_k`` orders them."""
    x = _tied_scores()
    v_ref, i_ref = jax_refs["top_k"]
    v, i = t_feat.stable_topk(torch.from_numpy(x), 120)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("shape,n_out", SELECT_CASES)
def test_select_grid_topk_with_ties(jax_refs, shape, n_out):
    """Per-cell + global selection on a score map full of ties (integer and
    zero scores) picks the same pixels in the same order as the JAX package."""
    score = _grid_scores(shape)
    yx_j, v_j = jax_refs["select", shape, n_out]
    yx_t, v_t = t_feat._select_grid_topk(torch.from_numpy(score), n_out, 32, 16)
    np.testing.assert_array_equal(yx_t.numpy(), np.asarray(yx_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def _dual_extraction():
    front, bird = _image(FRONT, 5), _image(BIRD, 6)
    mask = np.ones(BIRD, bool)
    mask[:40] = False
    ext = jax.jit(functools.partial(j_feat.extract_dual, cfg=JaxOrb(), n_a=2048, n_b=2048),
                  compiler_options=XLA_OPTS)
    ja, jb = jax.tree.map(np.asarray, ext(jnp.asarray(front), jnp.asarray(bird),
                                          mask_b=jnp.asarray(mask)))
    ta, tb = t_feat.extract_dual(torch.from_numpy(front), torch.from_numpy(bird), OrbConfig(),
                                 2048, 2048, mask_b=torch.from_numpy(mask))
    return (ja, ta), (jb, tb)


torch_refs.register("torch_extract_dual", __file__, _dual_extraction)


@pytest.fixture(scope="module")
def dual_extraction(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_extract_dual")


@pytest.mark.parametrize("view", [0, 1])
def test_extract_dual_matches_jax(dual_extraction, view):
    """Keypoint xy, level, valid and descriptors equal on >= 99.5% of valid
    slots (resize round-off can flip a FAST threshold test)."""
    jk, tk = dual_extraction[view]
    valid = np.asarray(jk.valid)
    assert valid.sum() > 1000
    same = (np.all(np.isclose(tk.xy.numpy(), np.asarray(jk.xy), atol=1e-3), -1)
            & (tk.level.numpy() == np.asarray(jk.level))
            & (tk.valid.numpy() == valid)
            & np.all(tk.desc.numpy().view(np.uint32) == np.asarray(jk.desc), -1))
    n_diff = int((~same & valid).sum())
    print(f"view {view}: {n_diff} of {int(valid.sum())} valid slots differ")
    assert n_diff <= 0.005 * valid.sum()
    np.testing.assert_allclose(tk.angle.numpy()[same], np.asarray(jk.angle)[same], atol=1e-3)
