"""Parity of the port's keyframes and local mapping with the JAX package on
the CPU, at the slice tests' small capacity (K=16, P=1024, PB=512, M=4,
F=FB=256).  Every map is built with numpy: keyframes on a short drive whose
features are the projections of numpy-drawn world points (0.3 px and 5 mm
noise, a few descriptor bits flipped per observation).  JAX computes all of
its references in one program, once per test run (``torch_refs.shared``).

Tolerances: integer, boolean and descriptor outputs equal; positions within
1e-4 m + 1e-5 of their value where no bundle adjustment ran (a triangulated
point at 24 m moves by 2e-4 m between the two QR routes).  After a bundle adjustment, the spread
of f32 on these problems sets the bounds (the port in f32 against the port in
f64 differs by up to 1.2e-5 in poses, 0.0062 px in reprojection and 9.4e-3 m
in points on the ties scene below): poses within 2e-4 (se3 log), bird points
within 5e-3 m, front points reprojected into each keyframe that observes them
within 0.02 px and within 1% of their range, since depth along the rays is
the weak direction (``tests/test_torch_ba.py``).

Two writes of the JAX package are lost by design of its scatters: it sends
the rows it does not write to feature F-1 or keyframe slot K-1 and restores
the old value there, and when the real write also goes there the restore can
win.  A third write is one it should not make: its local BA clears the
observation flags of landmarks outside the window that pad the landmark
selection.  The port writes only the rows it means to.  The cases below
build these on purpose and hold the port to the write that was meant
(ROADMAP, queue 3)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import tracking as j_tr
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.slam import map_state as t_ms
from fishbirdeyevisualslam_torch.slam import tracking as t_tr

import torch_refs
from torch_scenes import (K, TCFG, TCFG_TIES, F, _project, _recycled, _swap_slots,
                          crowd_scene, fault_scene, obs_batch, pressure_scene, slice_scene,
                          ties_scene)

torch.set_num_threads(1)

JCFG = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG.capacity)))
JCFG_TIES = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG_TIES.capacity)))
N_NEIGHBORS = TCFG.tracking.mapping_neighbors
POSE_TOL, POINT_TOL, PX_TOL = 2e-4, 5e-3, 0.02


def _np(tup):
    return {k: np.array(v) for k, v in tup._asdict().items()}


def _jax_program(inp):
    """Every JAX reference of this module, as one program."""
    J = lambda d: j_ms.MapState(**d)
    out = {}
    # the slice: insert the frame, then the mapping stages before local BA
    s = inp["slice"]
    m1 = j_tr.insert_keyframe(J(s["m"]), j_tr.Frame(**s["frame"]), j_tr.TrackObs(**s["assoc"]),
                              s["Tcw"], JCFG_TIES, jnp.int32(15), slot=jnp.int32(3))
    out["slice_insert"] = m1
    out["slice_pre"] = j_tr.local_mapping_pre(m1, jnp.int32(3), JCFG_TIES, N_NEIGHBORS)
    sm = J(s["m"])
    out["covis"] = j_ms.covisibility_counts(sm)
    out["bird_covis"] = j_ms.bird_covisibility_counts(sm)
    out["point_obs_count"] = j_ms.point_obs_count(sm)
    rec = J(inp["recycled"])
    out["temporal_perm"] = j_ms.temporal_perm(rec)
    out["reassign"] = j_ms.reassign_orphan_refs(rec)
    want = inp["want"]
    dest, can = j_ms.alloc_slots(sm.mp_valid, want)
    out["alloc"] = (dest, can)
    out["reset_point_slots"] = j_ms.reset_point_slots(sm, dest, can, jnp.int32(7))
    ob, bb = inp["obs"], inp["bobs"]
    out["add_observation"] = j_ms.add_observation(sm, ob["pt"], ob["kf"], ob["feat"],
                                                  ob["valid"])
    out["add_bird_observation"] = j_ms.add_bird_observation(sm, bb["pt"], bb["kf"], bb["feat"],
                                                            bb["valid"])
    # the dump collisions, on the fault scene with its frame inserted
    fm = J(inp["fault_insert"])
    out["triangulate"] = j_tr.triangulate_new_points(fm, jnp.int32(3), jnp.int32(0), JCFG)
    out["fuse"] = j_tr.fuse_neighbors(fm, jnp.int32(3), jnp.int32(1), JCFG)
    # ties, and a live local keyframe in slot K-1
    t = J(inp["ties"])
    out["top_covis"] = j_tr._top_covis_neighbors(t, jnp.int32(4), 3)
    out["window"] = j_tr._local_window_masks(t, JCFG_TIES, jnp.int32(4))
    out["truncation"] = j_tr.local_ba_truncation(t, JCFG_TIES, jnp.int32(4))
    out["odom_edges"] = j_tr.odom_chain_edges(rec, JCFG, rec.kf_valid)
    # upkeep
    out["relieve"] = j_tr.relieve_point_pressure(J(inp["pressure"]), JCFG, jnp.int32(2))
    c = J(inp["crowd"])
    out["cull_points"] = j_tr.cull_points(c, JCFG)
    out["cull_keyframes"] = j_tr.cull_keyframes(c, JCFG)
    out["update_point_stats"] = j_tr.update_point_stats(c, JCFG)
    out["force_evict"] = j_tr.force_evict_keyframe(c, JCFG)
    return out


def _inputs():
    """The scenes; the fault scene's frame is inserted by the port (the slice
    test holds ``insert_keyframe`` to JAX's)."""
    sl, fa = slice_scene(), fault_scene()
    ties = ties_scene()
    rng = np.random.RandomState(5)
    return dict(slice=sl, fault=fa, fault_insert=_mnp(_insert(fa)), ties=ties,
                ties_swapped=_swap_slots(ties, K - 1, 7), ties_outside=ties_scene(outside=True),
                recycled=_recycled(sl["m"]), want=rng.rand(F) < 0.2,
                obs=obs_batch(6, 12), bobs=obs_batch(7, 12),
                pressure=pressure_scene(sl["m"]), crowd=crowd_scene())


def _as_jax(tree):
    """The scenes as the JAX package holds them: +/-1 descriptors in bf16."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        return jnp.asarray(x, jnp.bfloat16) if name.endswith("desc_pm1") else x
    return jax.tree_util.tree_map_with_path(leaf, tree)


# the references are small programs: XLA's backend at optimisation level 0
# compiles them with about half the CPU time
XLA_OPTS = {"xla_backend_optimization_level": 0}


def _jax_refs():
    """``_jax_program``, then ``local_ba`` (compiled once for the three maps
    of the same shapes) and, for the slice, ``cull_keyframes``: with
    ``local_mapping_pre`` that is what its ``local_mapping_step`` runs."""
    raw = _inputs()
    inp = _as_jax(raw)
    out = jax.jit(_jax_program).lower(inp).compile(XLA_OPTS)(inp)
    J = lambda d: j_ms.MapState(**d)
    local_ba = j_tr.local_ba.lower(J(inp["ties"]), JCFG_TIES, jnp.int32(4)).compile(XLA_OPTS)
    ba = lambda m, center: local_ba(m, jnp.int32(center))
    out["slice_step"] = j_tr.cull_keyframes(ba(out["slice_pre"], 3), JCFG_TIES)
    out["local_ba_ties"] = ba(J(inp["ties"]), 4)
    out["local_ba_swapped"] = ba(J(inp["ties_swapped"]), 4)
    out["local_ba_outside"] = ba(J(inp["ties_outside"]), 4)
    return dict(inputs=raw, **jax.tree.map(np.asarray, out))


torch_refs.register("torch_mapping", __file__, _jax_refs)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_mapping")


# ---------------------------------------------------------------------------
# the port on the same inputs
# ---------------------------------------------------------------------------


def _tm(d):
    return convert.map_state_from_numpy(d, "cpu")


def _mnp(m):
    return convert.map_state_to_numpy(m)


def _frame(d):
    return convert.frame_from_numpy(d, "cpu")


def _obs(d):
    return t_tr.TrackObs(torch.from_numpy(d["mp_idx"]), torch.from_numpy(d["bp_idx"]))


def _insert(s):
    return t_tr.insert_keyframe(_tm(s["m"]), _frame(s["frame"]), _obs(s["assoc"]),
                                torch.from_numpy(s["Tcw"]), TCFG, 15, slot=3, device="cpu")


def _equal_maps(got, want, skip=(), pos_tol=1e-4):
    """Every field equal (floats within ``pos_tol`` + 1e-5 relative) but those
    in ``skip``."""
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=pos_tol, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _points_agree(got, want):
    """Landmarks after a bundle adjustment: reprojected into each keyframe
    that observes them within PX_TOL, and within 1% of their range from the
    world origin."""
    v = want["mp_valid"]
    for s in np.nonzero(want["kf_valid"])[0]:
        seen = v & np.any((want["obs_kf"] == s) & want["obs_valid"], axis=1)
        if seen.any():
            ug, _ = _project(want["kf_Tcw"][s], got["mp_pos"][seen])
            uw, _ = _project(want["kf_Tcw"][s], want["mp_pos"][seen])
            assert np.abs(ug - uw).max() < PX_TOL, s
    rng_ = np.linalg.norm(want["mp_pos"][v], axis=-1) + 1.0
    assert (np.linalg.norm(got["mp_pos"][v] - want["mp_pos"][v], axis=-1) / rng_).max() < 0.01


@pytest.fixture(scope="module")
def slice_run(ref):
    m1 = _insert(ref["inputs"]["slice"])
    m2 = t_tr.local_mapping_step(m1, 3, TCFG_TIES, N_NEIGHBORS, device="cpu")
    return _mnp(m1), _mnp(m2)


def test_slice_insert_keyframe(ref, slice_run):
    want = _np(ref["slice_insert"])
    _equal_maps(slice_run[0], want)
    assert want["n_bp"] > ref["inputs"]["slice"]["m"]["n_bp"]      # bird points were created
    assert (want["kf_mp"][3] >= 0).sum() > 100


def test_slice_local_mapping_step(ref, slice_run):
    """insert_keyframe then local_mapping_step, with the small window of
    TCFG_TIES (it holds all 4 keyframes of the slice scene): every discrete
    field equal, poses within POSE_TOL, bird points within POINT_TOL, front
    points as ``_points_agree`` says."""
    got, want = slice_run[1], _np(ref["slice_step"])
    before = ref["inputs"]["slice"]["m"]
    assert want["n_mp"] > before["n_mp"] + 10                           # triangulation ran
    assert (want["obs_valid"].sum() != _np(ref["slice_insert"])["obs_valid"].sum())
    _equal_maps(got, want, skip=("kf_Tcw", "mp_pos", "bp_pos", "mp_min_dist", "mp_max_dist"))
    dT = t_se3.log(t_se3.compose(torch.from_numpy(got["kf_Tcw"]),
                                 t_se3.inverse(torch.from_numpy(want["kf_Tcw"]))))
    assert dT.abs().max() < POSE_TOL
    assert np.abs(got["kf_Tcw"] - before["kf_Tcw"]).max() > 1e-4          # BA moved poses
    np.testing.assert_allclose(got["bp_pos"], want["bp_pos"], atol=POINT_TOL)
    _points_agree(got, want)
    np.testing.assert_allclose(got["mp_max_dist"], want["mp_max_dist"], rtol=1e-2)


def test_covisibility(ref):
    m = _tm(ref["inputs"]["slice"]["m"])
    np.testing.assert_array_equal(t_ms.covisibility_counts(m).numpy(), ref["covis"])
    np.testing.assert_array_equal(t_ms.bird_covisibility_counts(m).numpy(), ref["bird_covis"])
    np.testing.assert_array_equal(t_ms.point_obs_count(m).numpy(), ref["point_obs_count"])
    assert ref["covis"][0, 1] > 50


def test_temporal_perm_and_orphans(ref):
    m = _tm(ref["inputs"]["recycled"])
    np.testing.assert_array_equal(t_ms.temporal_perm(m).numpy(), ref["temporal_perm"])
    _equal_maps(_mnp(t_ms.reassign_orphan_refs(m)), _np(ref["reassign"]))
    assert (ref["inputs"]["recycled"]["mp_ref_kf"] != _np(ref["reassign"])["mp_ref_kf"]).any()


def test_reset_point_slots(ref):
    m = _tm(ref["inputs"]["slice"]["m"])
    dest, can = t_ms.alloc_slots(m.mp_valid, torch.from_numpy(ref["inputs"]["want"]))
    np.testing.assert_array_equal(dest.numpy(), ref["alloc"][0])
    _equal_maps(_mnp(t_ms.reset_point_slots(m, dest, can, 7)), _np(ref["reset_point_slots"]))


@pytest.mark.parametrize("bird", [False, True])
def test_add_observation(ref, bird):
    """Repeated points take successive slots; past the last slot they are dropped."""
    b = ref["inputs"]["bobs" if bird else "obs"]
    fn = t_ms.add_bird_observation if bird else t_ms.add_observation
    got = fn(_tm(ref["inputs"]["slice"]["m"]), *(torch.from_numpy(b[k])
                                                 for k in ("pt", "kf", "feat", "valid")))
    want = _np(ref["add_bird_observation" if bird else "add_observation"])
    _equal_maps(_mnp(got), want)
    valid = (want["bobs_valid"] if bird else want["obs_valid"])[:12]
    assert valid.all(axis=1).any()                                     # some point filled up


def test_odom_chain_edges(ref):
    m = _tm(ref["inputs"]["recycled"])
    got = t_tr.odom_chain_edges(m, TCFG, m.kf_valid)
    want = ref["odom_edges"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    assert want.valid.sum() >= 3


def test_topk_ties():
    w = torch.tensor([3, 7, 3, 7, 1, 7, 3, 0], dtype=torch.int32)
    vals, idx = t_tr._topk_stable(w, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(w.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(vals.numpy(), jv)


def test_top_covis_neighbors_ties(ref):
    nb, ok = t_tr._top_covis_neighbors(_tm(ref["inputs"]["ties"]), 4, 3)
    np.testing.assert_array_equal(nb.numpy(), ref["top_covis"][0])
    np.testing.assert_array_equal(ok.numpy(), ref["top_covis"][1])
    np.testing.assert_array_equal(nb.numpy(), [K - 1, 0, 1])


def test_local_window_ties(ref):
    got = t_tr._local_window_masks(_tm(ref["inputs"]["ties"]), TCFG_TIES, 4)
    for g, w in zip(got, ref["window"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sorted(np.nonzero(ref["window"][0])[0]) == [0, 1, 4, K - 1]
    np.testing.assert_array_equal(
        t_tr.local_ba_truncation(_tm(ref["inputs"]["ties"]), TCFG_TIES, 4).numpy(),
        ref["truncation"])


@pytest.fixture(scope="module")
def ties_ba(ref):
    return _mnp(t_tr.local_ba(_tm(ref["inputs"]["ties"]), TCFG_TIES, 4))


def test_local_ba_ties(ref, ties_ba):
    """local_ba with tied covisibility weights: the same window, observers and
    results, but for slot K-1 (below)."""
    want = _np(ref["local_ba_ties"])
    _equal_maps(ties_ba, want, skip=("kf_Tcw", "mp_pos", "bp_pos"))
    keep = np.arange(K) != K - 1
    dT = t_se3.log(t_se3.compose(torch.from_numpy(ties_ba["kf_Tcw"][keep]),
                                 t_se3.inverse(torch.from_numpy(want["kf_Tcw"][keep]))))
    assert dT.abs().max() < POSE_TOL
    np.testing.assert_allclose(ties_ba["bp_pos"], want["bp_pos"], atol=POINT_TOL)
    _points_agree(ties_ba, want)
    moved = np.abs(want["kf_Tcw"] - ref["inputs"]["ties"]["kf_Tcw"]).max(1) > 1e-6
    np.testing.assert_array_equal(np.nonzero(moved)[0], [1, 4])   # 0 is the gauge


def test_local_ba_slot_k_minus_1(ref, ties_ba):
    """Slot K-1 holds a live local keyframe.  The JAX package loses its pose
    update (the dump rows' restore lands after it); the port writes it, and
    writes what JAX computes for the same keyframe moved to slot 7."""
    before = ref["inputs"]["ties"]["kf_Tcw"][K - 1]
    np.testing.assert_array_equal(_np(ref["local_ba_ties"])["kf_Tcw"][K - 1], before)
    swapped = _np(ref["local_ba_swapped"])["kf_Tcw"][7]
    assert np.abs(swapped - before).max() > 1e-5
    d = t_se3.log(t_se3.compose(torch.from_numpy(ties_ba["kf_Tcw"][K - 1]),
                                t_se3.inverse(torch.from_numpy(swapped))))
    assert d.abs().max() < POSE_TOL


def test_local_ba_padding_rows(ref, ties_ba):
    """Front landmark 72 and bird landmark 18 are live and seen only by the
    observers 2 and 3, so they are outside the window and fill the first
    padding rows of the landmark selections.  The JAX package writes the
    padding rows back and clears their observations (the bundle adjustment
    classifies an observation of a landmark it did not optimise as an
    outlier); the port leaves them as they were.  Everything else is held
    to JAX as on the ties scene, and to the port's run without the two."""
    inp = ref["inputs"]["ties_outside"]
    got = _mnp(t_tr.local_ba(_tm(inp), TCFG_TIES, 4))
    want = _np(ref["local_ba_outside"])
    assert inp["obs_valid"][72].sum() == 2 and inp["bobs_valid"][18].sum() == 2
    assert not want["obs_valid"][72].any() and not want["bobs_valid"][18].any()
    fixed = {k: v.copy() for k, v in want.items()}
    fixed["obs_valid"][72] = inp["obs_valid"][72]
    fixed["bobs_valid"][18] = inp["bobs_valid"][18]
    _equal_maps(got, fixed, skip=("kf_Tcw", "mp_pos", "bp_pos"))
    np.testing.assert_array_equal(got["mp_pos"][72], inp["mp_pos"][72])
    np.testing.assert_array_equal(got["bp_pos"][18], inp["bp_pos"][18])
    keep = np.arange(K) != K - 1
    dT = t_se3.log(t_se3.compose(torch.from_numpy(got["kf_Tcw"][keep]),
                                 t_se3.inverse(torch.from_numpy(want["kf_Tcw"][keep]))))
    assert dT.abs().max() < POSE_TOL
    np.testing.assert_allclose(got["bp_pos"], want["bp_pos"], atol=POINT_TOL)
    _points_agree(got, fixed)
    rows = {"mp_pos": 72, "obs_valid": 72, "bp_pos": 18, "bobs_valid": 18}
    for k in ("kf_Tcw", *rows):
        g = got[k].copy()
        if k in rows:
            g[rows[k]] = ties_ba[k][rows[k]]
        np.testing.assert_array_equal(g, ties_ba[k], err_msg=k)


def _consistent(m, slot):
    """Every valid observation of a live point by ``slot`` is mirrored in
    ``kf_mp``: the features whose association was lost."""
    v = m["obs_valid"] & m["mp_valid"][:, None] & (m["obs_kf"] == slot)
    p, s = np.nonzero(v)
    f = m["obs_feat"][p, s]
    return f[m["kf_mp"][slot, f] != p]


def test_triangulate_new_points_feature_f_minus_1(ref):
    """Keyframe 0's feature F-1 is triangulated with the frame's feature 5.
    JAX records the observation but loses ``kf_mp[0, F-1]``; the port keeps
    it.  Everything else is equal."""
    fm = ref["inputs"]["fault_insert"]
    got = _mnp(t_tr.triangulate_new_points(_tm(fm), 3, 0, TCFG))
    want = _np(ref["triangulate"])
    assert want["n_mp"] > fm["n_mp"]
    np.testing.assert_array_equal(_consistent(want, 0), [F - 1])
    assert len(_consistent(got, 0)) == 0
    pt = want["kf_mp"][3, 5]
    assert pt >= 0 and got["kf_mp"][0, F - 1] == pt
    fixed = {k: v.copy() for k, v in want.items()}
    fixed["kf_mp"][0, F - 1] = pt
    _equal_maps(got, fixed)


def test_fuse_neighbors_merge_and_feature_f_minus_1(ref):
    """The frame's point lands on keyframe 1's free feature F-1 (JAX loses
    ``kf_mp[1, F-1]``, the port keeps it), and its two duplicates (slots 900,
    901) merge into the landmarks keyframe 1 holds."""
    fm = ref["inputs"]["fault_insert"]
    got = _mnp(t_tr.fuse_neighbors(_tm(fm), 3, 1, TCFG))
    want = _np(ref["fuse"])
    pv = ref["inputs"]["fault"]["pt_v"]
    assert not want["mp_valid"][900] and not want["mp_valid"][901]
    np.testing.assert_array_equal(_consistent(want, 1), [F - 1])
    assert len(_consistent(got, 1)) == 0 and got["kf_mp"][1, F - 1] == pv
    fixed = {k: v.copy() for k, v in want.items()}
    fixed["kf_mp"][1, F - 1] = pv
    _equal_maps(got, fixed)


def test_relieve_point_pressure(ref):
    got = _mnp(t_tr.relieve_point_pressure(_tm(ref["inputs"]["pressure"]), TCFG, 2))
    want = _np(ref["relieve"])
    assert want["n_pressure_evicted"] > 100
    _equal_maps(got, want)


@pytest.mark.parametrize("fn", ["cull_points", "cull_keyframes", "update_point_stats",
                                "force_evict"])
def test_upkeep(ref, fn):
    port = {"force_evict": t_tr.force_evict_keyframe}.get(fn, getattr(t_tr, fn, None))
    crowd = ref["inputs"]["crowd"]
    got = _mnp(port(_tm(crowd), TCFG))
    want = _np(ref[fn])
    changed = {k for k in want if not np.array_equal(want[k], crowd[k])}
    assert changed, fn                                                  # it did something
    _equal_maps(got, want, pos_tol=1e-5)


BASE = dict(localization_only=False, n_kfs=10, frame_id=100, last_kf_frame_id=90,
            last_reloc_frame_id=-10000, n_inliers=50, n_ref_matches=100, mapping_idle=True)
POLICY_CASES = [dict(), dict(localization_only=True), dict(last_reloc_frame_id=95, n_kfs=30),
                dict(last_reloc_frame_id=95, n_kfs=10), dict(n_inliers=95, last_kf_frame_id=0),
                dict(n_inliers=15), dict(last_kf_frame_id=74, mapping_idle=False),
                dict(mapping_idle=False, last_kf_frame_id=99), dict(last_kf_frame_id=100),
                dict(n_inliers=95, n_bird_matched=1, n_ref_bird=100)]


@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_need_new_keyframe(case):
    """The cases of tests/test_kf_policy.py."""
    kw = dict(BASE, **POLICY_CASES[case])
    assert t_tr.need_new_keyframe(TCFG, **kw) == j_tr.need_new_keyframe(JCFG, **kw)


def test_free_kf_slot(ref):
    m = _tm(ref["inputs"]["recycled"])
    slot, ok, n_free = t_tr.free_kf_slot(m)
    assert (int(slot), bool(ok), int(n_free)) == (1, True, K - 3)
    full = m._replace(kf_valid=torch.ones(K, dtype=torch.bool))
    assert not bool(t_tr.free_kf_slot(full)[1])


def test_io_copies():
    """The port's copies of io/synthetic.py and io/evaluate.py give the JAX
    package's images (>= 99.9% of the pixels within 1e-3 grey levels: the
    camera mounting matrix is computed by each package's geometry) and ATE
    (within 1e-5 m)."""
    from fishbirdeyevisualslam_tpu.io import evaluate as j_ev
    from fishbirdeyevisualslam_tpu.io import synthetic as j_syn
    from fishbirdeyevisualslam_torch.io import evaluate as t_ev
    from fishbirdeyevisualslam_torch.io import synthetic as t_syn
    gt = t_syn.make_trajectory(6, "arc", step=0.5)
    np.testing.assert_array_equal(gt, j_syn.make_trajectory(6, "arc", step=0.5))
    world = t_syn.make_world(0, extent=30.0, traj=gt)
    # a quarter-size front camera: the same rays, 1/16 of the pixels
    cam = dataclasses.replace(TCFG.camera, width=238, height=100, fx=87.125, fy=86.75,
                              cx=120.0, cy=75.5)
    tcfg = TCFG.replace(camera=cam)
    jcfg = JCFG.replace(camera=type(JCFG.camera)(**dataclasses.asdict(cam)))
    for render in ("render_bird", "render_front"):
        got = getattr(t_syn, render)(world, tcfg, gt[3])
        want = getattr(j_syn, render)(world, jcfg, gt[3])
        assert (np.abs(got - want) <= 1e-3).mean() >= 0.999, render
    rng = np.random.RandomState(0)
    Twb = np.concatenate([np.tile([1.0, 0, 0, 0], (6, 1)), gt[:, :2] + rng.randn(6, 2) * 0.05,
                          np.zeros((6, 1))], -1).astype(np.float32)
    Twb[:, :4] = [[np.cos(t / 2), 0, 0, np.sin(t / 2)] for t in gt[:, 2]]
    ate = t_ev.ate_rmse_vs_gt(Twb, gt)
    assert 0 < ate < 0.2
    assert abs(ate - j_ev.ate_rmse_vs_gt(Twb, gt)) < 1e-5
