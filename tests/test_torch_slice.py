"""The port's per-frame slice as a whole against the JAX package, at reduced
capacity (K=16, P=1024, PB=512, M=4, F=FB=256) and full image size.

The map is built from a JAX frame itself: its valid front keypoints lifted at
numpy-drawn depths, half of its bird keypoints through ``bird_cam``, with
their descriptors; the same images are then tracked from a perturbed pose.
Checked: ``track_frame_core`` on the same converted frame and map (pose
within 1e-3, associations equal on >= 99% of rows, scalars 0, 2, 3, 5, 6
equal and 1, 4 within 5), and raw images -> ``build_frame`` ->
``track_frame_core`` (pose within 1e-3, motion-model matches within 2%).
Also the JAX <-> port state conversions."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import tracking as j_tr
from fishbirdeyevisualslam_tpu.slam.frame import build_frame as j_build_frame
from fishbirdeyevisualslam_torch import config as t_config
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.slam import frame as t_frame
from fishbirdeyevisualslam_torch.slam import tracking as t_tr
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt

import torch_refs

torch.set_num_threads(1)

F = FB = 256
P, PB, K, M = 1024, 512, 16, 4
JCFG = JaxConfig().replace(capacity=JaxCap(max_keyframes=K, max_points=P, max_bird_points=PB,
                                           max_obs_per_point=M, max_front_kp=F, max_bird_kp=FB))
TCFG = convert.config_from_dict(dataclasses.asdict(JCFG))
# the references are compiled with XLA's backend at optimisation level 0: the
# same programs, with about half the compile's CPU time
XLA_OPTS = {"xla_backend_optimization_level": 0}


def _image(shape, seed):
    img = gaussian_filter(np.random.RandomState(seed).rand(*shape), 1.5)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def _np(tup):
    return {k: np.array(v) for k, v in tup._asdict().items()}


def _build_map(fr, rng):
    """A map whose points are the frame's own keypoints (numpy, JAX layout)."""
    m = _np(j_ms.empty_map(JCFG))
    rows = np.nonzero(fr["kp_valid"])[0][:P]
    n = len(rows)
    z = rng.uniform(4, 30, n).astype(np.float32)
    c = JCFG.camera
    uv = fr["uv"][rows]
    Xc = np.stack([(uv[:, 0] - c.cx) * z / c.fx, (uv[:, 1] - c.cy) * z / c.fy, z], -1)
    m["mp_pos"][:n] = Xc
    m["mp_desc"][:n] = fr["desc"][rows]
    m["mp_desc_pm1"][:n] = fr["desc_pm1"][rows]
    m["mp_valid"][:n] = True
    # predicted level = the keypoint's octave, half a level from either boundary
    m["mp_max_dist"][:n] = np.linalg.norm(Xc, axis=-1) * 1.2 ** (fr["octave"][rows] - 0.5)
    m["mp_min_dist"][:n] = m["mp_max_dist"][:n] / 1.2 ** 7
    for s, frac in ((0, 1), (1, 2), (2, 4)):   # observed by 1, 2 or 3 keyframes
        m["obs_kf"][:n, s] = s
        m["obs_valid"][: n // frac, s] = True
    m["kf_valid"][:3] = True
    m["kf_seq"][:3] = np.arange(3)
    m["n_kf"] = m["kf_counter"] = np.int32(3)
    m["kf_mp"][0, rows] = np.arange(n)
    brows = np.nonzero(fr["bird_kp_valid"])[0]
    brows = brows[: len(brows) // 2]          # the rest create frame-born points
    nb = len(brows)
    m["bp_pos"][:nb] = fr["bird_cam"][brows]
    m["bp_desc"][:nb] = fr["bird_desc"][brows]
    m["bp_desc_pm1"][:nb] = fr["bird_desc_pm1"][brows]
    m["bp_valid"][:nb] = True
    m["bobs_kf"][:nb, 0] = 0
    m["bobs_valid"][:nb, 0] = True
    m["kf_bird_mp"][0, brows] = np.arange(nb)
    return m, n


def _compile_jax_track():
    """JAX's track_frame_core compiled from the argument shapes alone, so
    that the compile overlaps the JAX frame build."""
    sds = lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype)
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    jf = jax.eval_shape(lambda a, b, c, d, e: j_build_frame(a, b, c, d, e, JCFG, F, None, FB),
                        f32(400, 950), f32(384, 384), f32(384, 384), f32(3), f32())
    return jax.jit(j_tr.track_frame_core, static_argnums=(2,)).lower(
        jax.tree.map(sds, j_ms.empty_map(JCFG)), jf, JCFG, f32(7), i32(2 * F), i32(),
        jax.eval_shape(j_tr.bird_only_view, jf), i32(FB), f32(7),
        jax.ShapeDtypeStruct((), jnp.bool_)).compile(XLA_OPTS)


def _jax_refs():
    """The JAX side, as numpy trees: the frame, the map built from it, the
    tracking inputs and JAX's track_frame_core on them."""
    with ThreadPoolExecutor(1) as pool:
        j_track = pool.submit(_compile_jax_track)
        rng = np.random.RandomState(0)
        front, bird = _image((400, 950), 0), _image((384, 384), 1)
        mask = np.full((384, 384), 255, np.float32)
        jf = jax.jit(lambda a, b, c, d, e: j_build_frame(a, b, c, d, e, JCFG, F, None, FB),
                     compiler_options=XLA_OPTS)(jnp.asarray(front), jnp.asarray(bird),
                                                jnp.asarray(mask), jnp.zeros(3), jnp.float32(0.0))
        fr = _np(jf)
        m, n = _build_map(fr, rng)
        cand = np.full(2 * F, -1, np.int32)
        cand[::2] = np.arange(F) % n
        T_pred = np.array(j_se3.exp(jnp.asarray([0.002, -0.001, 0.0015, 0.03, -0.02, 0.04],
                                                jnp.float32)))
        last_bp = np.full(FB, -1, np.int32)
        last_bp[200:] = np.arange(FB - 200)       # shared landmarks
        T_last = np.array(j_se3.identity())
        jout = j_track.result()(
            j_ms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), jf,
            jnp.asarray(T_pred), jnp.asarray(cand), jnp.int32(0), j_tr.bird_only_view(jf),
            jnp.asarray(last_bp), jnp.asarray(T_last), jnp.asarray(True))
    return dict(front=front, bird=bird, mask=mask, fr=fr, m=m, cand=cand, T_pred=T_pred,
                last_bp=last_bp, T_last=T_last, jout=jax.tree.map(np.asarray, jout))


def _slice_run():
    ref = _jax_refs()
    return dict(ref, **_port_run(ref))


torch_refs.register("torch_slice", __file__, _slice_run)


@pytest.fixture(scope="module")
def slice_run(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_slice")


def _port_run(ref):
    """The port on the JAX side's inputs: the same converted frame and map,
    the CUDA route with its plain kernels, and raw images -> build_frame."""
    fr, m = ref["fr"], ref["m"]
    front, bird, mask = ref["front"], ref["bird"], ref["mask"]
    args = (torch.from_numpy(ref["T_pred"]), torch.from_numpy(ref["cand"]), 0)
    last = (torch.from_numpy(ref["last_bp"]), torch.from_numpy(ref["T_last"]), True)
    tf = convert.frame_from_numpy(fr, "cpu")
    tm = convert.map_state_from_numpy(m, "cpu")
    # record the pose optimisations the tracking core looks up in the wrapper module
    pose_calls = []
    wrapper = cuda_pose_opt.pose_optimization
    cuda_pose_opt.pose_optimization = lambda *a, **k: pose_calls.append(a[2]) or wrapper(*a, **k)
    try:
        tout = t_tr.track_frame_core(tm, tf, TCFG, *args, t_tr.bird_only_view(tf), *last,
                                     device="cpu")
    finally:
        cuda_pose_opt.pose_optimization = wrapper
    # the CUDA route with caps that make both compactions engage
    cfg_cap = TCFG.replace(tracking=dataclasses.replace(
        TCFG.tracking, local_match_compact_cap=P - 1, bird_match_compact_cap=PB - 1))
    tout_fused = t_tr._track_frame_core(tm, tf, cfg_cap, *args, t_tr.bird_only_view(tf), *last,
                                        fused=True)
    tf_raw = t_frame.build_frame(front, bird, mask, np.zeros(3, np.float32), 0.0, TCFG, F, None,
                                 FB, device="cpu")
    tout_raw = t_tr.track_frame_core(tm, tf_raw, TCFG, *args, t_tr.bird_only_view(tf_raw),
                                     *last, device="cpu")
    return dict(tout=tout, tout_fused=tout_fused, tf_raw=tf_raw, tout_raw=tout_raw,
                pose_calls=pose_calls)


def _pose_diff(a, b):
    d = j_se3.log(j_se3.compose(jnp.asarray(a), j_se3.inverse(jnp.asarray(b))))
    return float(np.abs(np.asarray(d)).max())


def test_scalars_are_not_trivial(slice_run):
    """The map built from the frame gives every counter something to count."""
    s = np.asarray(slice_run["jout"].scalars)
    assert s[0] > 100 and s[1] > 100 and s[2] > 10 and s[4] > 100, s


def test_track_pose(slice_run):
    assert _pose_diff(slice_run["tout"].Tcw.numpy(), slice_run["jout"].Tcw) < 1e-3


@pytest.mark.parametrize("field", ["mp_idx", "bp_idx"])
def test_track_associations(slice_run, field):
    got = getattr(slice_run["tout"], field).numpy()
    ref = np.asarray(getattr(slice_run["jout"], field))
    assert (ref >= 0).sum() > 100
    assert (got == ref).mean() >= 0.99


def test_track_scalars(slice_run):
    got = slice_run["tout"].scalars.numpy()
    ref = np.asarray(slice_run["jout"].scalars)
    np.testing.assert_array_equal(got[[0, 2, 3, 5, 6]], ref[[0, 2, 3, 5, 6]])
    assert np.all(np.abs(got[[1, 4]] - ref[[1, 4]]) <= 5), (got, ref)


def test_track_map_updates(slice_run):
    """Found/visible counters and the frame-born bird points match."""
    got = convert.map_state_to_numpy(slice_run["tout"].map)
    ref = _np(slice_run["jout"].map)
    np.testing.assert_array_equal(got["mp_visible"], ref["mp_visible"])
    assert (got["mp_found"] == ref["mp_found"]).mean() >= 0.99
    assert (got["bp_valid"] == ref["bp_valid"]).mean() >= 0.99
    assert ref["bp_valid"].sum() > slice_run["m"]["bp_valid"].sum()   # CREATE ran
    same = got["bp_valid"] & ref["bp_valid"]
    np.testing.assert_array_equal(got["bp_desc"][same], ref["bp_desc"][same])
    np.testing.assert_allclose(got["bp_pos"][same], ref["bp_pos"][same], atol=1e-4)


def test_pose_steps_go_through_the_wrapper_module(slice_run):
    """Both pose optimisations of a frame are looked up in
    ``solvers/cuda_pose_opt.py`` at each call, so that swapping the module's
    attribute (as chip_smoke.py does for its plain reference) reaches them."""
    assert len(slice_run["pose_calls"]) == 2


def test_fused_route_equals_dense_route(slice_run):
    """The CUDA route (fused matchers with compaction), run here with the
    kernels' plain versions, gives the dense route's results exactly."""
    a, b = slice_run["tout_fused"], slice_run["tout"]
    for x, y in ((a.Tcw, b.Tcw), (a.mp_idx, b.mp_idx), (a.bp_idx, b.bp_idx),
                 (a.scalars, b.scalars)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("field", ["uv_raw", "octave", "kp_valid", "desc", "bird_uv",
                                   "bird_desc", "bird_kp_valid", "bird_cam"])
def test_build_frame_matches_jax(slice_run, field):
    got = convert.frame_to_numpy(slice_run["tf_raw"])[field]
    ref = slice_run["fr"][field]
    eq = np.isclose(got, ref, atol=1e-3) if ref.dtype == np.float32 else got == ref
    eq = eq.reshape(len(eq), -1).all(-1)
    assert eq.mean() >= 0.995, eq.mean()


def test_raw_images_track(slice_run):
    out, ref = slice_run["tout_raw"], slice_run["jout"]
    assert _pose_diff(out.Tcw.numpy(), ref.Tcw) < 1e-3
    n_ref = int(ref.scalars[0])
    assert abs(int(out.scalars[0]) - n_ref) <= 0.02 * n_ref


def test_convert_frame_round_trip(slice_run):
    """uint32 descriptor words survive as int32 bits (sign bit included),
    bf16 +/-1 through float32, bool as bool."""
    fr = slice_run["fr"]
    assert (fr["desc"] >= 2**31).any()
    tf = convert.frame_from_numpy(fr, "cpu")
    assert tf.desc.dtype == torch.int32 and tf.desc_pm1.dtype == torch.bfloat16
    assert tf.kp_valid.dtype == torch.bool
    back = convert.frame_to_numpy(tf)
    for k, v in fr.items():
        assert back[k].dtype == (np.float32 if v.dtype.name == "bfloat16" else v.dtype), k
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))


def test_convert_map_round_trip(slice_run):
    m = slice_run["m"]
    back = convert.map_state_to_numpy(convert.map_state_from_numpy(m, "cpu"))
    assert set(back) == set(m)
    for k, v in m.items():
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))
    assert back["mp_desc"].dtype == np.uint32


def test_config_from_dict():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(t_config.SystemConfig()) == dataclasses.asdict(JaxConfig())


def test_track_rejects_bool_candidate_mask(slice_run):
    tf = convert.frame_from_numpy(slice_run["fr"], "cpu")
    tm = convert.map_state_from_numpy(slice_run["m"], "cpu")
    with pytest.raises(ValueError):
        t_tr.track_frame_core(tm, tf, TCFG, torch.zeros(7), torch.zeros(P, dtype=torch.bool),
                              device="cpu")


def test_entry_points_want_a_card_by_default():
    """With no device named, entry points run on CUDA or raise: no silent CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_frame.build_frame(np.zeros((64, 64), np.float32), np.zeros((64, 64), np.float32),
                            np.ones((64, 64), np.float32), np.zeros(3), 0.0, TCFG, 64)
