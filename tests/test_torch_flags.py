"""The port's behaviour switches and the contour mask on the CPU, against the
JAX package.

  * ``config.reference_parity()`` field by field against the JAX one;
  * ``slam/frame.py:bird_detection_mask`` (the contour gate of the bird
    keypoints) against JAX's ``reduce_window`` dilation, exact, with contour
    edges on every image border and on a degraded render's contour;
  * one small case per switch, at the mapping tests' capacity (K=16, P=1024,
    PB=512, F=FB=256), on the numpy scenes of ``torch_scenes.py`` and
    ``test_torch_init.py``:
      - ``init_level0_only`` in ``match_for_init`` (the init frame pair whose
        features sit on levels 0 and 1): equal;
      - ``filter_gate_mult`` 1 and 3 in ``match_bird_points`` (the slice
        scene tracked from a pose 2 cm off, its bird points' camera
        coordinates under 3 cm of noise, so that the two gates keep
        different matches): equal;
      - ``tight_couple`` / ``tight_couple2`` in ``odom_chain_edges`` on a map
        with recycled slots: indices and flags equal, measurements within
        1e-6;
      - ``pose_prior_info = 0`` in ``pose_opt_step``:
        pose within 1e-3 (se3 log), inlier flips under 2%, ``n_inliers``
        within 5 (``tests/test_torch_pose_opt.py``'s bounds);
      - ``point_pressure_valve`` off in ``local_mapping_pre`` on the pressure
        scene (free slots under 1/16 of capacity): every field equal,
        positions within 1e-4 m + 1e-5 (``tests/test_torch_mapping.py``'s
        bound where no bundle adjustment runs), and nothing evicted where the
        valve on evicts.

JAX's references are one program, compiled at XLA's backend optimisation
level 0 and computed once per test run (``torch_refs.shared``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu import config as j_config
from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.slam import frame as j_frame
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import tracking as j_tr
from fishbirdeyevisualslam_torch import config as t_config
from fishbirdeyevisualslam_torch import convert, reference_parity
from fishbirdeyevisualslam_torch.geometry import ipm as t_ipm
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.io import synthetic as t_syn
from fishbirdeyevisualslam_torch.slam import frame as t_frame
from fishbirdeyevisualslam_torch.slam import tracking as t_tr

import torch_refs
from test_torch_init import frame_pair
from torch_scenes import TCFG, _recycled, pressure_scene, slice_scene

torch.set_num_threads(1)

JCFG = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG.capacity)))
N_NEIGHBORS = TCFG.tracking.mapping_neighbors
XLA_OPTS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False,
            "xla_cpu_parallel_codegen_split_count": 1}
GATES = (1.0, 3.0)
COUPLINGS = ((False, True), (True, False), (False, False))   # (tight_couple, tight_couple2)


def _with(cfg, **sections):
    """``cfg`` with fields of its sections replaced: ``flags=dict(...)``."""
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


# ---------------------------------------------------------------------------
# reference_parity and the contour mask
# ---------------------------------------------------------------------------


def test_reference_parity_matches_jax():
    got, want = dataclasses.asdict(reference_parity()), dataclasses.asdict(
        j_config.reference_parity())
    assert got == want
    assert got != dataclasses.asdict(t_config.SystemConfig())
    assert reference_parity() == t_config.reference_parity()


def _contour_case(case: int):
    """A (freespace mask, contour) pair: 0, random labels with edges on all
    four borders and in the corners; 1, the same under a freespace mask that
    cuts edges off; 2, a degraded bird render's own mask and contour."""
    rng = np.random.RandomState(0)
    H, W = 48, 40
    contour = np.where(rng.rand(H, W) < 0.03, 0.0, 255.0).astype(np.float32)
    contour[0, 5], contour[H - 1, 17], contour[9, 0], contour[30, W - 1] = 0.0, 10.0, 100.0, 149.0
    contour[0, 0], contour[H - 1, W - 1] = 0.0, 0.0
    contour[20, 20] = 150.0                  # exactly 150 is no edge
    if case == 0:
        return np.ones((H, W), np.float32), contour
    if case == 1:
        free = (rng.rand(H, W) < 0.8).astype(np.float32)
        free[:, :3] = 0.0                    # a border column off the freespace
        return free, contour
    cfg = t_config.SystemConfig()
    bird = t_syn.render_bird(t_syn.make_world(2), cfg, np.zeros(3))
    mask, contour = t_syn.bird_mask_and_contour(cfg, bird)
    contour = t_syn.degrade_contour(contour, t_syn.DegradeConfig(), np.random.RandomState(5))
    return mask.astype(np.float32), contour.astype(np.float32)


@pytest.mark.parametrize("case", range(3))
def test_bird_detection_mask_matches_jax(case):
    free, contour = _contour_case(case)
    want = np.asarray(j_frame.bird_detection_mask(jnp.asarray(free), jnp.asarray(contour)))
    got = t_frame.bird_detection_mask(torch.from_numpy(free), torch.from_numpy(contour))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    if case == 0:   # a border edge's neighbourhood reaches 3 px inwards
        assert want[3, 5] and want[47, 39] and want[0, 0]


# ---------------------------------------------------------------------------
# the switches: inputs and JAX's references
# ---------------------------------------------------------------------------


def _noisy_bird(scene, rng):
    """The slice scene's frame with its bird keypoints' bird-image pixels and
    base points filled in, 3 cm of noise on their camera coordinates, and
    the pose it is tracked from (2 cm and 0.2 deg off)."""
    fr = dict(scene["frame"])
    ok = fr["bird_kp_valid"][:, None]
    base = t_ipm.cam_xyz_to_base(TCFG.extrinsics, torch.from_numpy(fr["bird_cam"]))
    fr["bird_base"] = np.where(ok, base.numpy(), 0).astype(np.float32)
    fr["bird_uv"] = np.where(ok, t_ipm.base_xy_to_bird_pixel(TCFG.bird, base).numpy(),
                             0).astype(np.float32)
    fr["bird_cam"] = (fr["bird_cam"] + rng.randn(*fr["bird_cam"].shape) * 0.03).astype(np.float32)
    Tcw = t_se3.retract(torch.from_numpy(scene["Tcw"]),
                        torch.tensor([0.0, 0.003, 0.0, 0.02, 0.0, 0.01])).numpy()
    return fr, Tcw


def _inputs():
    rng = np.random.RandomState(9)
    sl = slice_scene()
    frame, Tcw = _noisy_bird(sl, rng)
    return dict(pair=frame_pair(4, TCFG.capacity.max_front_kp, matched_last=True),
                slice=dict(m=sl["m"], frame=frame, assoc=sl["assoc"], Tcw=Tcw),
                recycled=_recycled(sl["m"]), pressure=pressure_scene(sl["m"]))


def _jtree(tree):
    """The scenes as the JAX package holds them: +/-1 descriptors in bf16."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        return jnp.asarray(x, jnp.bfloat16) if name.endswith("desc_pm1") else x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_program(inp):
    J, Fr = (lambda d: j_ms.MapState(**d)), (lambda d: j_tr.Frame(**d))
    out = {}
    f1, f2 = (Fr(d) for d in inp["pair"])
    out["init_level0"] = j_tr.match_for_init(f1, f2, _with(JCFG, tracking=dict(
        init_level0_only=True)))
    s = inp["slice"]
    m, f, Tcw = J(s["m"]), Fr(s["frame"]), s["Tcw"]
    cand = jnp.ones((m.bp_pos.shape[0],), bool)
    for gate in GATES:
        out[f"bird_gate {gate}"] = j_tr.match_bird_points(
            m, f, _with(JCFG, bird=dict(filter_gate_mult=gate)), Tcw, cand)
    rec = J(inp["recycled"])
    for tc, tc2 in COUPLINGS:
        out[f"odom {tc} {tc2}"] = j_tr.odom_chain_edges(
            rec, _with(JCFG, flags=dict(tight_couple=tc, tight_couple2=tc2)), rec.kf_valid)
    out["valve_off"] = j_tr.local_mapping_pre(
        J(inp["pressure"]), jnp.int32(2), _with(JCFG, tracking=dict(point_pressure_valve=False)),
        N_NEIGHBORS)
    return out


def _prior_program(s):
    m, f = j_ms.MapState(**s["m"]), j_tr.Frame(**s["frame"])
    return j_tr.pose_opt_step(m, f, j_tr.TrackObs(**s["assoc"]),
                              _with(JCFG, ba=dict(pose_prior_info=0.0)), s["Tcw"])


def _jax_refs():
    raw = _inputs()
    inp = _jtree(raw)
    out = jax.jit(_jax_program).lower(inp).compile(XLA_OPTS)(inp)
    return dict(inputs=raw, **jax.tree.map(np.asarray, out))


def _jax_prior():
    """The pose LM's reference, a compile of its own (a registered fixture
    of its own, so that another worker can compute it meanwhile)."""
    s = _jtree(_inputs()["slice"])
    return jax.tree.map(np.asarray, jax.jit(_prior_program).lower(s).compile(XLA_OPTS)(s))


torch_refs.register("torch_flags", __file__, _jax_refs, cost=8.0)
torch_refs.register("torch_flags_prior", __file__, _jax_prior, cost=7.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_flags")


@pytest.fixture(scope="module")
def prior_ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_flags_prior")


def _tm(d):
    return convert.map_state_from_numpy(d, "cpu")


def _tf(d):
    return convert.frame_from_numpy(d, "cpu")


def _same_match(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the port on the same inputs
# ---------------------------------------------------------------------------


def test_init_level0_only(ref):
    f1, f2 = (_tf(d) for d in ref["inputs"]["pair"])
    cfg = _with(TCFG, tracking=dict(init_level0_only=True))
    got = t_tr.match_for_init(f1, f2, cfg)
    _same_match(got, ref["init_level0"])
    # every level: held against JAX by tests/test_torch_init.py
    n0, n_all = int(ref["init_level0"].ok.sum()), int(t_tr.match_for_init(f1, f2, TCFG).ok.sum())
    assert 20 < n0 < n_all, (n0, n_all)
    octave = ref["inputs"]["pair"][0]["octave"]
    assert (octave[ref["init_level0"].ok] == 0).all()


@pytest.mark.parametrize("gate", GATES)
def test_filter_gate_mult(ref, gate):
    s = ref["inputs"]["slice"]
    m, f = _tm(s["m"]), _tf(s["frame"])
    cfg = _with(TCFG, bird=dict(filter_gate_mult=gate))
    cand = torch.ones(m.bp_pos.shape[0], dtype=torch.bool)
    got = t_tr.match_bird_points(m, f, cfg, torch.from_numpy(s["Tcw"]), cand, None, fused=False)
    _same_match(got, ref[f"bird_gate {gate}"])
    n1, n3 = (int(ref[f"bird_gate {g}"].ok.sum()) for g in GATES)
    assert 50 < n1 < n3, (n1, n3)


@pytest.mark.parametrize("tc,tc2", COUPLINGS)
def test_odom_chain_edges_couplings(ref, tc, tc2):
    m = _tm(ref["inputs"]["recycled"])
    cfg = _with(TCFG, flags=dict(tight_couple=tc, tight_couple2=tc2))
    got, want = t_tr.odom_chain_edges(m, cfg, m.kf_valid), ref[f"odom {tc} {tc2}"]
    for name, g, w in zip(got._fields, got, want):
        if np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    K = TCFG.capacity.max_keyframes
    assert len(want.i) == (K - 1 if not tc2 else 3 * K - 6)
    assert want.valid.any() == tc


def _pose_diff(a, b) -> float:
    d = t_se3.log(t_se3.compose(torch.as_tensor(np.array(a)), t_se3.inverse(torch.as_tensor(np.array(b)))))
    return float(d.abs().max())


def test_pose_prior_info_zero(ref, prior_ref):
    s = ref["inputs"]["slice"]
    m, f = _tm(s["m"]), _tf(s["frame"])
    assoc = t_tr.TrackObs(torch.from_numpy(s["assoc"]["mp_idx"]),
                          torch.from_numpy(s["assoc"]["bp_idx"]))
    T0 = torch.from_numpy(s["Tcw"])
    got = t_tr.pose_opt_step(m, f, assoc, _with(TCFG, ba=dict(pose_prior_info=0.0)), T0)
    want = prior_ref
    assert _pose_diff(got.Tcw, want.Tcw) < 1e-3
    assert (got.front_inlier.numpy() != want.front_inlier).mean() < 0.02
    assert (got.bird_inlier.numpy() != want.bird_inlier).mean() < 0.02
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 5
    # the default prior (held against JAX by tests/test_torch_slice.py) anchors
    # the pose elsewhere
    anchored = t_tr.pose_opt_step(m, f, assoc, TCFG, T0)
    assert TCFG.ba.pose_prior_info > 0 and _pose_diff(got.Tcw, anchored.Tcw) > 1e-5


def test_point_pressure_valve_off(ref):
    inp = ref["inputs"]["pressure"]
    off = _with(TCFG, tracking=dict(point_pressure_valve=False))
    counts_off, counts_on = {}, {}
    got = convert.map_state_to_numpy(t_tr.local_mapping_pre(
        _tm(inp), 2, off, N_NEIGHBORS, device="cpu", counts=counts_off))
    want = {k: np.asarray(v) for k, v in ref["valve_off"]._asdict().items()}
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=1e-4, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    t_tr.local_mapping_pre(_tm(inp), 2, TCFG, N_NEIGHBORS, device="cpu", counts=counts_on)
    assert int(counts_off["evicted"]) == 0 < int(counts_on["evicted"])
    assert int(want["n_pressure_evicted"]) == int(inp["n_pressure_evicted"])
