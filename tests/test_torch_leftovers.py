"""Parity of the port's functions that nothing in the system calls with the
JAX package, on the inputs of the JAX package's own tests of them:
``geometry/camera.py`` (``tests/test_geometry.py:101,108``), ``ipm.py``,
``se3.py``, ``ops/fast.py:fast_score_map`` (``tests/test_ops.py:35-52``),
``ops/image.py``, ``ops/features.py:extract`` (``tests/test_ops.py:115-141``),
``ops/vocab.py`` (``tests/test_place_recognition.py:31-43``),
``solvers/pose_opt.py:bird_only_optimization`` (``tests/test_solvers.py:149``)
and ``slam/tracking.py:match_map_points_dual`` on ``torch_scenes.slice_scene``.
JAX's side is one program compiled at XLA optimisation level 0, run once
per test run (``torch_refs.shared``); each test states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import DEFAULT_CONFIG as JCFG0
from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import camera as j_cam
from fishbirdeyevisualslam_tpu.geometry import ipm as j_ipm
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.ops import fast as j_fast
from fishbirdeyevisualslam_tpu.ops import features as j_feat
from fishbirdeyevisualslam_tpu.ops import image as j_image
from fishbirdeyevisualslam_tpu.ops import vocab as j_vocab
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import tracking as j_tr
from fishbirdeyevisualslam_tpu.solvers import pose_opt as j_po
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.geometry import camera as t_cam
from fishbirdeyevisualslam_torch.geometry import ipm as t_ipm
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.ops import fast as t_fast
from fishbirdeyevisualslam_torch.ops import features as t_feat
from fishbirdeyevisualslam_torch.ops import image as t_image
from fishbirdeyevisualslam_torch.ops import vocab as t_vocab
from fishbirdeyevisualslam_torch.slam import tracking as t_tr
from fishbirdeyevisualslam_torch.solvers import pose_opt as t_po

import torch_refs
from torch_scenes import TCFG, slice_scene

torch.set_num_threads(1)

CFG = SystemConfig()
ORB4 = dataclasses.replace(CFG.orb, n_levels=4)           # tests/test_ops.py:13
JORB4 = dataclasses.replace(JCFG0.orb, n_levels=4)
JTCFG = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG.capacity)))
XLA_OPTS = {"xla_backend_optimization_level": 0}


def textured(h=160, w=160, seed=0):
    """tests/test_ops.py:textured."""
    rng = np.random.RandomState(seed)
    img = np.kron(rng.rand(h // 8, w // 8) * 255, np.ones((8, 8)))
    img += rng.rand(h, w) * 10
    return img.astype(np.float32)


def _square():
    img = np.full((60, 60), 20.0, np.float32)
    img[20:40, 20:40] = 220.0
    return img


def _inputs():
    """Every numpy input of the JAX program."""
    rng = np.random.RandomState(0)
    scene = slice_scene()
    m, fr = scene["m"], scene["frame"]
    cand = m["mp_valid"] & (rng.rand(m["mp_valid"].shape[0]) < 0.7)
    nb = 80
    brng = np.random.RandomState(6)      # tests/test_solvers.py:149's bird points
    Xb = np.stack([brng.uniform(2, 15, nb), brng.uniform(-5, 5, nb),
                   np.zeros(nb)], -1).astype(np.float32)
    mask = np.zeros((120, 160), bool)
    mask[:, :80] = True
    fast_img = (np.random.RandomState(1).rand(40, 40) * 255).astype(np.float32)
    v = j_vocab.load_vocabulary()
    leaves = np.asarray(v.centers_pm1[-j_vocab.N_WORDS:], np.float32) > 0
    bits = leaves[np.random.RandomState(0).choice(j_vocab.N_WORDS, 200, replace=False)]
    bits = (bits ^ (np.random.RandomState(1).rand(*bits.shape) < 0.02)).astype(np.uint8)
    return dict(
        m=m, frame=fr, Tcw=scene["Tcw"].astype(np.float32), cand=cand, Xb=Xb,
        img300=textured(160, 200), img_mask=textured(120, 160, seed=7), mask=mask,
        rgb=(rng.rand(24, 32, 3) * 255).astype(np.float32),
        blur=(rng.rand(30, 41) * 255).astype(np.float32),
        pix=np.stack([rng.uniform(0, 384, 50), rng.uniform(0, 384, 50)], -1).astype(np.float32),
        uv=np.array([[100.0, 80.0], [480.0, 302.0], [700.0, 350.0], [20.0, 380.0]], np.float32),
        xyz=np.array([[0.5, -0.2, 4.0], [1.0, 1.0, 10.0]], np.float32), fast_img=fast_img,
        square=_square(), vocab=v, bits=bits,
        descend_np=j_vocab.descend_np(bits, np.asarray(v.centers_pm1)),
        available=j_vocab.vocabulary_available())


def _jax_program(inp):
    """The JAX package's side, one jitted program."""
    cam, ba = JCFG0.camera, JCFG0.ba
    # tests/test_solvers.py:149's bird-only problem
    Tcw_true = j_se3.random_pose(jax.random.fold_in(jax.random.PRNGKey(42), 11), 0.1, 1.0)
    Xc = j_se3.transform(Tcw_true, inp["Xb"])
    Tcw0 = j_se3.retract(Tcw_true, jnp.array([0.02, 0.0, -0.02, 0.2, -0.2, 0.1]))
    bird = j_po.BirdObs(inp["Xb"], Xc, jnp.ones(80), jnp.ones(80, bool))
    few = bird._replace(valid=jnp.arange(80) < 2)
    m = j_ms.MapState(**{k: jnp.asarray(v, jnp.bfloat16) if k.endswith("desc_pm1") else v
                         for k, v in inp["m"].items()})
    f = j_tr.Frame(**{k: jnp.asarray(v, jnp.bfloat16) if k.endswith("desc_pm1") else v
                      for k, v in inp["frame"].items()})
    und = j_cam.undistort_fisheye(cam, inp["uv"])
    xyz = inp["xyz"]
    poses = jax.vmap(lambda k: j_se3.random_pose(k, 0.5, 2.0))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    pm1 = jnp.asarray(inp["bits"].astype(jnp.float32) * 2 - 1, jnp.bfloat16)
    return dict(
        extract=j_feat._extract_impl(inp["img300"], JORB4, 300),
        extract_mask=j_feat._extract_impl(inp["img_mask"], JORB4, 200,
                                          detection_mask=inp["mask"]),
        Tcw_true=Tcw_true, Xc=Xc, Tcw0=Tcw0,
        bird_only=j_po.bird_only_optimization(ba, Tcw0, bird),
        bird_few=j_po.bird_only_optimization(ba, Tcw0, few),
        dual=j_tr.match_map_points_dual(m, f, JTCFG, inp["Tcw"], inp["cand"], 15.0,
                                        float(JTCFG.matcher.th_high)),
        und=und, distort=j_cam.distort_fisheye(cam, und),
        backproject=j_cam.backproject_pinhole(cam, j_cam.project_pinhole(cam, xyz), xyz[:, 2]),
        poses=poses, matrix=j_se3.to_matrix(poses),
        from_matrix=j_se3.from_matrix(j_se3.to_matrix(poses)),
        rotation=j_se3.rotation(poses), translation=j_se3.translation(poses),
        cam_xyz=j_ipm.bird_pixel_to_cam_xyz(JCFG0.bird, JCFG0.extrinsics, inp["pix"]),
        Tcw_from_Twb=j_ipm.Tcw_from_Twb(JCFG0.extrinsics, poses),
        fast=j_fast.fast_score_map(inp["fast_img"], 20.0),
        fast_square=j_fast.fast_score_map(inp["square"], 15.0),
        gray=j_image.rgb_to_gray(inp["rgb"]), blurred=j_image.gaussian_blur(inp["blur"]),
        descend=j_vocab.descend(pm1, inp["vocab"].centers_pm1))


def _jax_refs():
    inp = _inputs()
    out = jax.jit(_jax_program).lower(inp).compile(XLA_OPTS)(inp)
    return dict(inp, **jax.tree.map(np.asarray, out))


torch_refs.register("torch_leftovers_jax", __file__, _jax_refs, cost=20.0)


@pytest.fixture(scope="module")
def refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_leftovers_jax")


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_distort_fisheye(refs):
    """tests/test_geometry.py:96: the round trip within 1e-2 px; the port's
    distortion of JAX's undistorted pixels within 1e-3 px of JAX's."""
    got = t_cam.distort_fisheye(CFG.camera, T(refs["und"])).numpy()
    np.testing.assert_allclose(got, refs["distort"], atol=1e-3)
    back = t_cam.distort_fisheye(CFG.camera, t_cam.undistort_fisheye(CFG.camera, T(refs["uv"])))
    np.testing.assert_allclose(back.numpy(), refs["uv"], atol=1e-2)


def test_backproject_pinhole(refs):
    """tests/test_geometry.py:103: within 1e-5 m of JAX, 1e-4 of the points."""
    uv = t_cam.project_pinhole(CFG.camera, T(refs["xyz"]))
    got = t_cam.backproject_pinhole(CFG.camera, uv, T(refs["xyz"])[:, 2]).numpy()
    np.testing.assert_allclose(got, refs["backproject"], atol=1e-5)
    np.testing.assert_allclose(got, refs["xyz"], atol=1e-4)


def test_se3_matrix_and_parts(refs):
    """Exact for the slices; 1e-6 for the matrices and 1e-5 for the quaternion
    read back (a different branch-free Shepperd than JAX's may round apart)."""
    poses = T(refs["poses"])
    assert torch.equal(t_se3.rotation(poses), T(refs["rotation"]))
    assert torch.equal(t_se3.translation(poses), T(refs["translation"]))
    np.testing.assert_allclose(t_se3.to_matrix(poses).numpy(), refs["matrix"], atol=1e-6)
    np.testing.assert_allclose(t_se3.from_matrix(T(refs["matrix"])).numpy(), refs["from_matrix"],
                               atol=1e-5)


def test_random_pose_maps_draws_as_jax():
    """The pose from the generator's draws (omega, then t) is JAX's
    ``make(so3_exp_quat(omega), t)`` within 1e-6."""
    g = torch.Generator().manual_seed(11)
    got = t_se3.random_pose(g, 0.3, 2.0)
    g.manual_seed(11)
    omega, t = 0.3 * torch.randn(3, generator=g), 2.0 * torch.randn(3, generator=g)
    want = j_se3.make(j_se3.so3_exp_quat(jnp.asarray(omega.numpy())), jnp.asarray(t.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert abs(float(torch.linalg.vector_norm(got[:4])) - 1.0) < 1e-6


def test_ipm_leftovers(refs):
    """Within 1e-5 of JAX."""
    got = t_ipm.bird_pixel_to_cam_xyz(CFG.bird, CFG.extrinsics, T(refs["pix"]))
    np.testing.assert_allclose(got.numpy(), refs["cam_xyz"], atol=1e-5)
    got = t_ipm.Tcw_from_Twb(CFG.extrinsics, T(refs["poses"]))
    np.testing.assert_allclose(got.numpy(), refs["Tcw_from_Twb"], atol=1e-5)


# ---------------------------------------------------------------------------
# image, FAST and extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "square"])
def test_fast_score_map(refs, case):
    """tests/test_ops.py:35-52's inputs: corners equal, scores within 1e-3."""
    img, th, key = ((refs["fast_img"], 20.0, "fast") if case == "random"
                    else (_square(), 15.0, "fast_square"))
    score, corner = t_fast.fast_score_map(T(img), th)
    np.testing.assert_array_equal(corner.numpy(), refs[key][1])
    np.testing.assert_allclose(score.numpy(), refs[key][0], atol=1e-3)
    assert corner.any()
    assert torch.equal(t_fast._circle_stack(T(img))[4], torch.roll(T(img), (0, -3), (0, 1)))


def test_rgb_to_gray_and_blur(refs):
    """The luma within 1e-4 and the blur within 1e-3 grey levels of JAX's."""
    np.testing.assert_allclose(t_image.rgb_to_gray(T(refs["rgb"])).numpy(), refs["gray"],
                               atol=1e-4)
    got = t_image.gaussian_blur(T(refs["blur"]))
    assert got.shape == refs["blur"].shape
    np.testing.assert_allclose(got.numpy(), refs["blurred"], atol=1e-3)


def _same_keypoints(tk, jk):
    """The slots whose xy (1e-3 px), level, validity and descriptor agree."""
    return (np.all(np.isclose(tk.xy.numpy(), np.asarray(jk.xy), atol=1e-3), -1)
            & (tk.level.numpy() == np.asarray(jk.level))
            & (tk.valid.numpy() == np.asarray(jk.valid))
            & np.all(tk.desc.numpy().view(np.uint32) == np.asarray(jk.desc), -1))


@pytest.mark.parametrize("masked", [False, True])
def test_extract(refs, masked):
    """tests/test_ops.py:115-141: the keypoints of >= 99.5% of the valid slots
    equal (the bound of ``test_extract_dual_matches_jax``); with the mask,
    no valid keypoint outside it."""
    if masked:
        jk = refs["extract_mask"]
        tk = t_feat.extract(T(refs["img_mask"]), ORB4, 200, detection_mask=T(refs["mask"]))
        assert (tk.xy.numpy()[tk.valid.numpy()][:, 0] < 80).all()
    else:
        jk = refs["extract"]
        tk = t_feat.extract(T(refs["img300"]), ORB4, 300)
        assert tk.xy.shape == (300, 2) and tk.desc.shape == (300, 8)
    valid = np.asarray(jk.valid)
    assert valid.sum() > (50 if masked else 100)
    assert int((~_same_keypoints(tk, jk) & valid).sum()) <= 0.005 * valid.sum()


def test_extract_is_one_view_of_extract_dual(refs):
    """``extract`` gives exactly the front view of ``extract_dual`` (the plain
    versions of kernels 1 and 2 on the CPU)."""
    a, b = T(refs["img300"]), T(textured(96, 128, seed=3))
    one = t_feat.extract(a, ORB4, 300)
    dual = t_feat.extract_dual(a, b, ORB4, 300, 100)[0]
    for x, y in zip(one, dual):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------


def test_vocabulary_copy_and_descent(refs):
    """The port's copy of the vocabulary equals JAX's (also through
    ``convert.from_numpy``); ``descend`` and ``descend_np`` give JAX's word
    ids exactly; ``word_ids`` is the descent of the package's vocabulary."""
    v = t_vocab.load_vocabulary(device="cpu")
    assert torch.equal(v.centers_pm1.float(), T(refs["vocab"].centers_pm1.astype(np.float32)))
    assert torch.equal(v.idf, T(refs["vocab"].idf))
    conv = convert.from_numpy(t_vocab.Vocabulary, refs["vocab"], device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(conv, v))
    assert t_vocab.vocabulary_available() == bool(refs["available"])
    assert not t_vocab.vocabulary_available("/nonexistent/orb_vocab.npz")
    pm1 = T(refs["bits"].astype(np.float32) * 2 - 1).to(torch.bfloat16)
    words = t_vocab.descend(pm1, v.centers_pm1)
    np.testing.assert_array_equal(words.numpy(), refs["descend"])
    assert torch.equal(t_vocab.word_ids(pm1), words)
    np.testing.assert_array_equal(t_vocab.descend_np(refs["bits"], v.centers_pm1.float().numpy()),
                                  refs["descend_np"])


# ---------------------------------------------------------------------------
# the bird-only LM and the dual map match
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bird_only", "bird_few"])
def test_bird_only_optimization(refs, case):
    """tests/test_solvers.py:149's problem: the pose within 1e-4 of JAX's (and
    1e-3 of the truth), the inlier mask and count equal; with 2 valid rows
    the seed comes back."""
    valid = np.arange(80) < (2 if case == "bird_few" else 80)
    got = t_po.bird_only_optimization(CFG.ba, T(refs["Tcw0"]), t_po.BirdObs(
        T(refs["Xb"]), T(refs["Xc"]), torch.ones(80), T(valid)))
    ref = refs[case]
    d = j_se3.log(j_se3.compose(jnp.asarray(got.Tcw.numpy()), j_se3.inverse(ref.Tcw)))
    assert float(np.abs(np.asarray(d)).max()) < 1e-4
    np.testing.assert_array_equal(got.bird_inlier.numpy(), np.asarray(ref.bird_inlier))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert got.front_inlier.shape == (0,)
    if case == "bird_few":
        assert torch.equal(got.Tcw, T(refs["Tcw0"]))
    else:
        d = j_se3.log(j_se3.compose(jnp.asarray(got.Tcw.numpy()),
                                    j_se3.inverse(jnp.asarray(refs["Tcw_true"]))))
        assert float(np.abs(np.asarray(d)).max()) < 1e-3
        assert int(got.n_inliers) == 80


def test_match_map_points_dual(refs):
    """The mask form on the slice scene: both results (idx, dist, ok) equal
    to JAX's, to the ids form over the mask's ids, and to the ids form over
    the compacted ids the card route builds."""
    m = convert.map_state_from_numpy(refs["m"], "cpu")
    f = convert.frame_from_numpy(refs["frame"], "cpu")
    Tcw, cand = T(refs["Tcw"]), T(refs["cand"])
    th = float(TCFG.matcher.th_high)
    got = t_tr.match_map_points_dual(m, f, TCFG, Tcw, cand, 15.0, th)
    for r, ref in zip(got, refs["dual"]):
        for x, y in zip(r, ref):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(got[0].count) > 50
    P = cand.shape[0]
    for cap in (0, 2 * int(cand.sum()), P // 2 - 1):
        ids = t_tr._mask_to_ids(cand, cap)
        assert ids.shape[0] == (cap if 0 < cap < P and int(cand.sum()) <= cap else P)
        alt = t_tr.match_map_points_dual_ids(m, f, TCFG, Tcw, ids, 15.0, th, False)
        for r, a in zip(got, alt):
            assert all(torch.equal(x, y) for x, y in zip(r, a))


def test_mask_lookup():
    """``_mask_lookup`` is ``mask[idx]`` (JAX's packs the table into words)."""
    mask = torch.from_numpy(np.random.RandomState(0).rand(70) < 0.5)
    idx = torch.from_numpy(np.random.RandomState(1).randint(0, 70, (9, 4)).astype(np.int32))
    want = np.asarray(j_tr._mask_lookup(jnp.asarray(mask.numpy()), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(t_tr._mask_lookup(mask, idx).numpy(), want)
