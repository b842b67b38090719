"""Parity of the port's relocalization with the JAX package on the CPU, and
the facade's recovery: ``slam/loop_closing.py``'s ``_covis_group_masks``,
``relocalize_candidates``, ``relocalize_group_candidates`` and
``relocalize_against``, and ``slam/system.py``'s ``_append_reinit_pair``,
the ``TrackReferenceKeyFrame`` fallback and the LOST state.

The relocalization functions run on ``torch_scenes.loop_scene`` (K=16,
P=1024, PB=512, M=4, F=FB=256) with a query frame back at drive step 2, JAX
in one program compiled at XLA's backend optimisation level 0, once per test
run (``torch_refs.shared``), its PRNG draws handed to the port.
``_append_reinit_pair`` runs on the mapping tests' slice map with
``test_torch_init.py``'s fault pair, whose second frame's feature F-1 is
matched: the JAX package writes the new keyframe's ``kf_mp`` row through
feature F-1 for every unmatched row and loses that feature's point; the
port writes it (ROADMAP, queue 3), and every other field is equal.

The facade's recovery is held by its behaviour, on ``test_torch_system.py``'s
port facade (three frames of the rendered arc, F=FB=512): with the pose
belief 18 m and 0.3 rad off (``test_reloc.py``) it leaves LOST on the
revisited frame within 1.0 m of its own earlier estimate, and its
``relocalize_against`` agrees with JAX's on the same map, frame and draws:
the same matches, both successful, inliers within 5% and poses within
1e-2 (se3 log).  That RANSAC's hypotheses are EPnP on 4-point sets, whose
8 x 12 systems have an exact 4-dimensional null space: the JAX package
takes LAPACK's basis of it and the port one fixed by the span
(``solvers/pnp.py:_canonical_basis``), so single hypotheses differ and on
a real frame the winner can too.  The fallback's body tracks the third
frame where the motion model did; with relocalization starved the facade
re-initializes a new submap.

Tolerances: indices, counts and masks equal; scores within 1e-6 (group
scores 1e-5); RANSAC PnP poses within 1e-2 (se3 log; the same inliers, the
pose of a winning minimal hypothesis where no refit keeps them), points
within 1e-6 m.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.ops import bow as j_bow
from fishbirdeyevisualslam_tpu.ops import matcher as j_matcher
from fishbirdeyevisualslam_tpu.slam import loop_closing as j_lc
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import system as j_system
from fishbirdeyevisualslam_tpu.slam.frame import Frame as JFrame
from fishbirdeyevisualslam_tpu.solvers import initializer as j_init
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import ipm as t_ipm
from fishbirdeyevisualslam_torch.geometry import odometry as t_odo
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.ops import vocab as t_vocab
from fishbirdeyevisualslam_torch.slam import loop_closing as t_lc
from fishbirdeyevisualslam_torch.slam import map_state as t_ms
from fishbirdeyevisualslam_torch.slam import tracking as t_tr
from fishbirdeyevisualslam_torch.slam.frame import build_frame
from fishbirdeyevisualslam_torch.slam.system import SlamSystem
from fishbirdeyevisualslam_torch.solvers import initializer as t_init
from fishbirdeyevisualslam_torch.solvers.triangulate import triangulate

import test_torch_system as tsys
import torch_refs
from test_torch_init import frame_pair
from torch_scenes import F, TCFG, loop_scene, slice_scene

torch.set_num_threads(1)

JCFG = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG.capacity)))
XLA_OPTS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False,
            "xla_cpu_parallel_codegen_split_count": 1}
ITERS = 128
RANSAC_TOL = 1e-2   # se3 log: two RANSAC winners on the same matches, refit on their inliers
KEYS = (3, 4)   # the PRNG keys of relocalize_against on the two best candidates


def _jax(d):
    return {k: jnp.asarray(v, jnp.bfloat16 if k.endswith("desc_pm1") else None)
            for k, v in d.items()}


def _jframe(d):
    return JFrame(**_jax(d))


def _jmap(d):
    return j_ms.MapState(**_jax(d))


def _reinit_case():
    """The slice map, the fault pair (frame 2's feature F-1 matched), the
    port's ``match_for_init`` on it and an init result triangulated at the
    odometry's relative pose."""
    f1, f2 = frame_pair(4, F, matched_last=True)
    t1, t2 = (convert.frame_from_numpy(d, "cpu") for d in (f1, f2))
    res = t_tr.match_for_init(t1, t2, TCFG)
    T21 = t_se3.inverse(t_odo.preintegrate_cam(TCFG.extrinsics, t1.odom, t2.odom))
    uv2 = t_tr._matched_uv2(t1, t2, res)
    tri = triangulate(TCFG.camera, t_se3.identity(), T21, t1.uv, uv2)
    init = dict(success=np.bool_(True), T21=T21.numpy(), Xw=tri.Xw.numpy(),
                triangulated=(tri.valid & res.ok).numpy(), n_good=np.int32(int(tri.valid.sum())))
    return dict(m=slice_scene()["m"], f1=f1, f2=f2, init=init,
                res={k: v.numpy() for k, v in res._asdict().items()},
                last_Tcw=t_se3.exp(torch.tensor([0.01, 0.02, -0.05, 1.5, 0.1, 3.0])).numpy())


def _program(inp):
    m = _jmap(inp["loop"]["m"])
    q = _jframe(inp["loop"]["query"])
    words = j_bow.word_ids(q.desc_pm1)
    C = j_ms.covisibility_counts(m)
    out = dict(words=words, groups=j_lc._covis_group_masks(C, m.kf_valid),
               scores=j_lc.relocalize_candidates(m, words, JCFG, q.kp_valid))
    members, acc = j_lc.relocalize_group_candidates(m, words, JCFG, q.kp_valid)
    out["members"], out["acc"] = members, acc
    out["against"] = [j_lc.relocalize_against(m, q.desc_pm1, words, JCFG, q.uv, q.kp_valid,
                                              members[r], jax.random.PRNGKey(k))
                      for r, k in enumerate(KEYS)]
    out["draws"] = [jax.random.gumbel(jax.random.PRNGKey(k), (ITERS, F)) for k in KEYS]
    return out


def _jax_refs():
    raw = dict(loop=loop_scene(), reinit=_reinit_case())
    out = jax.jit(_program).lower(raw).compile(XLA_OPTS)(raw)
    r = raw["reinit"]
    host = types.SimpleNamespace(cfg=JCFG, last_Tcw=jnp.asarray(r["last_Tcw"]), frame_id=7)
    m, slot = j_system.SlamSystem._append_reinit_pair(
        host, _jmap(r["m"]), _jframe(r["f1"]), _jframe(r["f2"]),
        j_init.InitResult(**{k: jnp.asarray(v) for k, v in r["init"].items()}),
        j_matcher.MatchResult(**{k: jnp.asarray(v) for k, v in r["res"].items()}))
    out["reinit"] = dict(m=m, slot=slot)
    return dict(inputs=raw, **jax.tree.map(np.asarray, out))


torch_refs.register("torch_reloc", __file__, _jax_refs, cost=15.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_reloc")


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_err(a, b):
    a, b = _t(a).reshape(-1, 7), _t(b).reshape(-1, 7)
    return t_se3.log(t_se3.compose(a, t_se3.inverse(b))).abs().max().item()


def _query(ref):
    return convert.frame_from_numpy(ref["inputs"]["loop"]["query"], "cpu")


# ---------------------------------------------------------------------------
# relocalization against the loop map
# ---------------------------------------------------------------------------


def test_covis_group_masks(ref):
    m = convert.map_state_from_numpy(ref["inputs"]["loop"]["m"], "cpu")
    got = t_lc._covis_group_masks(t_ms.covisibility_counts(m), m.kf_valid)
    np.testing.assert_array_equal(got.numpy(), ref["groups"])


def test_relocalize_candidates(ref):
    m = convert.map_state_from_numpy(ref["inputs"]["loop"]["m"], "cpu")
    q = _query(ref)
    words = t_vocab.word_ids(q.desc_pm1)
    np.testing.assert_array_equal(words.numpy(), ref["words"])
    scores = t_lc.relocalize_candidates(m, words, TCFG, q.kp_valid)
    np.testing.assert_allclose(scores.numpy(), ref["scores"], atol=1e-6)
    members, acc = t_lc.relocalize_group_candidates(m, words, TCFG, q.kp_valid)
    np.testing.assert_array_equal(members.numpy(), ref["members"])
    np.testing.assert_allclose(acc.numpy(), ref["acc"], atol=1e-5)
    assert float(acc[0]) > 0.05


@pytest.mark.parametrize("rank", [0, 1])
def test_relocalize_against(ref, rank):
    m = convert.map_state_from_numpy(ref["inputs"]["loop"]["m"], "cpu")
    q = _query(ref)
    words = t_vocab.word_ids(q.desc_pm1)
    cand = int(ref["members"][rank])
    Tcw, mp_idx, n_in, ok = t_lc.relocalize_against(m, q.desc_pm1, words, TCFG, q.uv,
                                                    q.kp_valid, cand, _t(ref["draws"][rank]))
    wT, w_idx, w_n, w_ok = ref["against"][rank]
    np.testing.assert_array_equal(mp_idx.numpy(), w_idx)
    assert int(n_in) == int(w_n) and bool(ok) == bool(w_ok) and bool(w_ok)
    # where neither refit keeps its inliers the winning minimal hypothesis
    # stays, whose pose depends on the null-space basis
    assert _pose_err(Tcw, wT) <= RANSAC_TOL


# ---------------------------------------------------------------------------
# the re-initialization's keyframe pair
# ---------------------------------------------------------------------------


def test_append_reinit_pair_feature_f_minus_1(ref):
    """The new submap's pair: JAX loses the point of the second keyframe's
    feature F-1; the port writes it; every other field is equal."""
    r = ref["inputs"]["reinit"]
    host = SlamSystem(TCFG, device="cpu")
    host.last_Tcw, host.frame_id = _t(r["last_Tcw"]), 7
    init = t_init.InitResult(**{k: _t(v) for k, v in r["init"].items()},
                             used_h=torch.tensor(False))
    res = t_tr.matcher.MatchResult(**{k: _t(v) for k, v in r["res"].items()})
    m, slot = host._append_reinit_pair(convert.map_state_from_numpy(r["m"], "cpu"),
                                       convert.frame_from_numpy(r["f1"], "cpu"),
                                       convert.frame_from_numpy(r["f2"], "cpu"), init, res)
    assert slot == int(ref["reinit"]["slot"])
    got = convert.map_state_to_numpy(m)
    want = {k: np.asarray(v) for k, v in ref["reinit"]["m"]._asdict().items()}
    pt = got["kf_mp"][slot, F - 1]
    assert want["kf_mp"][slot, F - 1] == -1 and pt >= 0
    assert np.any((want["obs_kf"][pt] == slot) & (want["obs_feat"][pt] == F - 1)
                  & want["obs_valid"][pt])
    got["kf_mp"][slot, F - 1] = -1
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(want["n_mp"]) > int(r["m"]["n_mp"]) + 50


# ---------------------------------------------------------------------------
# the facade's recovery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def system_ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_system")


class RecordingDraws(tsys.JaxDraws):
    """JAX draws that remember the key of each call."""

    def __init__(self, seed: int):
        super().__init__(seed)
        self.keys = []

    def __call__(self, n: int, n_iters: int, n_points: int):
        self.keys.append(jax.random.split(self.key)[1])
        return super().__call__(n, n_iters, n_points)


def _facade(system_ref, seed: int):
    sys_ = copy.deepcopy(system_ref["after_init"])
    sys_.draws = RecordingDraws(seed)
    return sys_


def _track(sys_, system_ref, i, odom=None):
    fr = system_ref["frames"][i]
    return sys_.track(fr["front"], fr["bird"], fr["mask"],
                      system_ref["odom"][i] if odom is None else odom, fr["timestamp"])


def _Twb(sys_, Tcw):
    return t_ipm.Twb_from_Twc(TCFG.extrinsics, t_se3.inverse(_t(Tcw))).numpy()


def test_fallback(system_ref):
    """The reference-keyframe fallback on the third frame, as ``_track_ok``
    runs it under 10 motion-model matches: relocalization against the last
    keyframe, the local-map and bird matches, the second pose optimisation;
    it tracks the frame within 0.25 m of where the facade's motion model
    did, from 22 inliers against the core's."""
    sys_ = _facade(system_ref, 11)
    fr = system_ref["frames"][2]
    cap = tsys.SCFG.capacity
    f = build_frame(fr["front"], fr["bird"], fr["mask"], system_ref["odom"][2], fr["timestamp"],
                    sys_.cfg, cap.max_front_kp, None, cap.max_bird_kp, device="cpu")
    n_in, Tcw, assoc = sys_._fallback(sys_.map, f, sys_._motion_prior(f), 0)
    # the facade's gate within 2 x fps frames of an initialization: 10 inliers
    assert n_in >= 10 and int((assoc.mp_idx >= 0).sum()) == n_in
    want = system_ref["port"]["poses"][2]
    assert np.linalg.norm(_Twb(sys_, Tcw)[4:6] - _Twb(sys_, want)[4:6]) < 0.25
    assert len(sys_.draws.keys) == 1


def test_kidnapped_facade_relocalizes(system_ref, monkeypatch):
    """``test_reloc.py`` on the three-frame facade: the belief 18 m and 0.3
    rad off, LOST, the frame of step 1 revisited with the last odometry; the
    facade leaves LOST by relocalization within 1.0 m of its own estimate of
    that frame, and each ``relocalize_against`` it made equals JAX's."""
    sys_ = _facade(system_ref, 12)
    _track(sys_, system_ref, 2)
    revisit = 1
    before = sys_.frame_trajectory_Twb()[revisit]
    drift = t_se3.exp(torch.tensor([0.0, 0.0, 0.3, 18.0, 9.0, 0.0]))
    sys_.state = t_tr.LOST
    sys_.n_lost_frames = 1
    sys_.last_Tcw = t_se3.compose(sys_.last_Tcw, drift)
    sys_._reloc_frame_id = -10000
    calls = []
    real = t_lc.relocalize_against

    def spy(m, desc, words, cfg, uv, valid, cand, gumbel):
        out = real(m, desc, words, cfg, uv, valid, cand, gumbel)
        calls.append((convert.map_state_to_numpy(m), desc.float().numpy(), words.numpy(),
                      uv.numpy(), valid.numpy(), cand, [x.numpy() for x in out]))
        return out

    monkeypatch.setattr(t_lc, "relocalize_against", spy)
    Tcw = _track(sys_, system_ref, revisit, odom=system_ref["odom"][-1])
    assert sys_.state == t_tr.OK and sys_.last_route == "relocalized"
    assert np.linalg.norm(_Twb(sys_, Tcw)[4:6] - before[4:6]) < 1.0
    assert calls and len(calls) == len(sys_.draws.keys)
    jcfg = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(tsys.SCFG.capacity)))
    fn = None
    for (m, desc, words, uv, valid, cand, out), key in zip(calls, sys_.draws.keys):
        args = (_jmap(m), jnp.asarray(desc, jnp.bfloat16), words, jcfg, uv, valid,
                jnp.int32(cand), key)
        if fn is None:
            fn = j_lc.relocalize_against.lower(*args).compile(XLA_OPTS)
        wT, w_idx, w_n, w_ok = (np.asarray(x) for x in fn(*(a for a in args if a is not jcfg)))
        # the matches are the same; the RANSAC's minimal hypotheses are not
        # (the 4-dimensional null space's basis, solvers/pnp.py), so its
        # winner and inlier set may differ by a few points
        both = (out[1] >= 0) & (w_idx >= 0)
        np.testing.assert_array_equal(out[1][both], w_idx[both])
        assert np.sum((out[1] >= 0) != (w_idx >= 0)) <= 0.05 * int(w_n)
        assert abs(int(out[2]) - int(w_n)) <= 0.05 * int(w_n) and bool(out[3]) == bool(w_ok)
        assert _pose_err(out[0], wT) <= RANSAC_TOL


def test_lost_facade_reinitializes(system_ref):
    """LOST after the initialization with nothing to relocalize against (the
    keyframes' keypoints cleared): the facade re-initializes a new submap from
    the last frame and this one, two keyframes more, and tracks on."""
    sys_ = _facade(system_ref, 13)
    sys_.state = t_tr.LOST
    m = sys_.map
    sys_.map = m._replace(kf_kp_valid=torch.zeros_like(m.kf_kp_valid))
    n_kf = int(sys_.map.kf_valid.sum())
    Tcw = _track(sys_, system_ref, 2)
    assert sys_.state == t_tr.OK and sys_.last_route == "reinitialized"
    assert int(sys_.map.kf_valid.sum()) == n_kf + 2 and sys_.trajectory[-1].is_keyframe
    assert sys_.keyframe_indices().tolist()[-2:] == [1, 2]
    assert np.isfinite(Tcw).all()
    want = system_ref["port"]["poses"][2]
    assert np.linalg.norm(_Twb(sys_, Tcw)[4:6] - _Twb(sys_, want)[4:6]) < 0.2
