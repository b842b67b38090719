"""Parity of the port's Sim3 loop correction with the JAX package on the CPU:
``solvers/sim3_pose_graph.py`` (``optimize_sim3_pose_graph``,
``carry_points_sim3``), ``slam/loop_closing.py:correct_loop`` in both of its
branches and ``LoopCloser.process_keyframe`` under ``fix_scale = False``.

The pose graph on ``tests/test_sim3_pose_graph.py``'s three cases at their
sizes (a 12-vertex circle with 3% scale drift per step and a loop edge, the
fixed point of exact measurements on 8 vertices, points carried by a
correction with scale): the optimised similarities within 1e-4 of JAX's,
and the port's H = J^T J, assembled from per-edge 7 x 14 blocks, within f32
of the dense J^T J of the whole problem's Jacobian.  ``correct_loop`` and
the closer on ``torch_scenes.loop_scene`` (K=16, P=1024, PB=512, F=FB=256):
JAX's ``LoopCloser`` with ``fix_scale = False`` over the three return
keyframes, its loop functions compiled at XLA's backend optimisation level 0
and recorded (``test_torch_loop.py``'s harness), the port held on each
recorded call and running the same keyframes with JAX's ``PRNGKey(99)``
draws; the SE3 branch of ``correct_loop`` on the same inputs.  Tolerances
are ``test_torch_loop.py``'s: after an LM, poses within 2e-4 (se3 log),
front points within 0.02 px in their observing keyframes, bird points within
5e-3 m; everything else equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.geometry import sim3 as j_sim3
from fishbirdeyevisualslam_tpu.slam import loop_closing as j_lc
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.solvers import sim3_pose_graph as j_spg
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import sim3 as t_sim3
from fishbirdeyevisualslam_torch.slam import loop_closing as t_lc
from fishbirdeyevisualslam_torch.solvers import sim3_pose_graph as t_spg

import torch_refs
from test_torch_loop import JCFG, XLA_OPTS, JaxDraws, _as_jax, _compile, _jm, _maps_agree, _t, _tm
from torch_scenes import F, TCFG, loop_scene

torch.set_num_threads(1)

JCFG_S = JCFG.replace(flags=dataclasses.replace(JCFG.flags, fix_scale=False))
TCFG_S = TCFG.replace(flags=dataclasses.replace(TCFG.flags, fix_scale=False))
CLOSER_FNS = ("detect_loop_groups", "compute_loop_transform", "verify_loop_projection",
              "correct_loop", "search_and_fuse", "global_ba")
SIM3_TOL = 1e-4


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------


def _circle(K, radius=5.0):
    poses = []
    for k in range(K):
        th = 2 * np.pi * k / K
        q = j_se3.so3_exp_quat(jnp.array([0.0, 0.0, th]))
        t = jnp.array([radius * np.cos(th), radius * np.sin(th), 0.0], jnp.float32)
        poses.append(j_se3.inverse(j_se3.make(q, t)))
    return j_sim3.from_se3(jnp.stack(poses))


def _graph_cases():
    """test_sim3_pose_graph.py's inputs: (name, S0, fixed, edges, n_iters)."""
    K = 12
    S_gt = _circle(K)
    rel = lambda a, b: j_sim3.compose(S_gt[a], j_sim3.inverse(S_gt[b]))
    rel_gt = jax.vmap(rel)(jnp.arange(K - 1), jnp.arange(1, K))
    drift = j_sim3.exp(jnp.array([0.0, 0.0, 0.01, 0.03, 0.0, 0.0, np.log(1.03)]))
    rel_meas = jax.vmap(lambda S: j_sim3.compose(drift, S))(rel_gt)
    S = [S_gt[0]]
    for k in range(K - 1):
        S.append(j_sim3.compose(j_sim3.inverse(rel_meas[k]), S[-1]))
    ei = jnp.concatenate([jnp.arange(K - 1), jnp.array([K - 1])]).astype(jnp.int32)
    ej = jnp.concatenate([jnp.arange(1, K), jnp.array([0])]).astype(jnp.int32)
    S_meas = jnp.concatenate([rel_meas, rel(K - 1, 0)[None]], axis=0)
    drift_case = (jnp.stack(S), jnp.zeros(K, bool).at[0].set(True),
                  j_spg.Sim3Edges(ei, ej, S_meas, jnp.full(K, 100.0), jnp.ones(K, bool)), 25,
                  S_gt)
    K = 8
    S_gt = _circle(K)
    ei, ej = jnp.arange(K - 1, dtype=jnp.int32), jnp.arange(1, K, dtype=jnp.int32)
    S_meas = jax.vmap(lambda a, b: j_sim3.compose(S_gt[a], j_sim3.inverse(S_gt[b])))(ei, ej)
    fixed_case = (S_gt, jnp.zeros(K, bool).at[0].set(True),
                  j_spg.Sim3Edges(ei, ej, S_meas, jnp.full(K - 1, 100.0), jnp.ones(K - 1, bool)),
                  5, S_gt)
    return {"drift": drift_case, "fixed_point": fixed_case}


def _carry_case():
    S_old = jnp.stack([j_sim3.from_se3(j_se3.random_pose(jax.random.PRNGKey(i)))
                       for i in range(3)])
    corr = j_sim3.exp(jnp.array([0.0, 0.1, 0.0, 0.5, -0.2, 0.1, np.log(1.2)]))
    S_new = jax.vmap(lambda S: j_sim3.compose(S, j_sim3.inverse(corr)))(S_old)
    pts = jax.random.normal(jax.random.PRNGKey(9), (10, 3)) * 3.0
    return dict(points=pts, ref=jnp.zeros(10, jnp.int32), S_old=S_old, S_new=S_new, corr=corr)


def _closer(m, calls):
    """JAX's ``LoopCloser`` under ``fix_scale = False`` over the three return
    keyframes, its loop functions compiled at level 0 and recorded."""
    i32 = jnp.int32
    S = jnp.zeros(8, jnp.float32)
    T = jnp.zeros(7, jnp.float32)
    exe = {
        "detect_loop_groups": _compile(j_lc.detect_loop_groups, m, i32(4), JCFG_S),
        "compute_loop_transform": _compile(j_lc.compute_loop_transform, m, i32(6), i32(0), JCFG_S,
                                           jax.random.PRNGKey(0)),
        "verify_loop_projection": _compile(j_lc.verify_loop_projection, m, i32(6), i32(0), T,
                                           JCFG_S),
        "correct_loop": _compile(j_lc.correct_loop, m, i32(6), i32(0), S, JCFG_S),
        "search_and_fuse": _compile(j_lc.search_and_fuse, m, i32(6), i32(0), JCFG_S),
        "global_ba": _compile(j_lc.global_ba, m, JCFG_S),
    }
    saved = {name: getattr(j_lc, name) for name in CLOSER_FNS}

    def recorder(name):
        def call(*args, **kwargs):
            dyn = [a for a in args if not isinstance(a, JaxConfig)]
            res = exe[name](*dyn)
            calls.setdefault(name, []).append((dyn, res))
            return res
        return call

    try:
        for name in CLOSER_FNS:
            setattr(j_lc, name, recorder(name))
        closer = j_lc.LoopCloser(JCFG_S)
        closed, correcting = [], []
        for cur in (4, 5, 6):
            m, c = closer.process_keyframe(m, cur)
            closed.append(c)
            correcting.append(closer.correcting)
    finally:
        for name, fn in saved.items():
            setattr(j_lc, name, fn)
    return m, closed, correcting


def _jax_refs():
    out = {"graph": {}}
    for name, (S0, fixed, edges, n_iters, S_gt) in _graph_cases().items():
        run = jax.jit(lambda S0, fixed, edges, n=n_iters: j_spg.optimize_sim3_pose_graph(
            S0, fixed, edges, n_iters=n))
        out["graph"][name] = dict(S0=S0, fixed=fixed, edges=edges._asdict(), n_iters=n_iters,
                                  S_gt=S_gt, out=run.lower(S0, fixed, edges)
                                  .compile(XLA_OPTS)(S0, fixed, edges))
    c = _carry_case()
    c["out"] = jax.jit(j_spg.carry_points_sim3).lower(c["points"], c["ref"], c["S_old"], c["S_new"]) \
        .compile(XLA_OPTS)(c["points"], c["ref"], c["S_old"], c["S_new"])
    out["carry"] = c
    scene = loop_scene()
    m = j_ms.MapState(**_as_jax(scene["m"]))
    calls = {}
    final, closed, correcting = _closer(m, calls)
    out.update(final=final, closed=closed, correcting=correcting, calls=calls)
    (args, _), = calls["correct_loop"]
    se3_branch = _compile(j_lc.correct_loop, *args[:4], JCFG)
    out["correct_loop_se3"] = se3_branch(*args[:4])
    return dict(scene=scene, **jax.tree.map(np.asarray, out))


torch_refs.register("torch_sim3", __file__, _jax_refs, cost=45.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_sim3")


def _edges(d):
    return t_spg.Sim3Edges(*(_t(d[k]) for k in t_spg.Sim3Edges._fields))


# ---------------------------------------------------------------------------
# the pose graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["drift", "fixed_point"])
def test_optimize_sim3_pose_graph(ref, case, monkeypatch):
    c = ref["graph"][case]
    monkeypatch.setattr(t_spg, "SIM3_ITERS", int(c["n_iters"]))
    got = t_spg.optimize_sim3_pose_graph(_t(c["S0"]), _t(c["fixed"]), _edges(c["edges"])).numpy()
    np.testing.assert_allclose(got, c["out"], atol=SIM3_TOL)
    if case == "drift":   # the loop edge pulls the scale back to 1 (the JAX test's claims)
        assert abs(got[-1, 7] - 1.0) < 0.05
        center = lambda S: t_sim3.transform(t_sim3.inverse(_t(S)), torch.zeros(3)).numpy()
        before = np.linalg.norm(center(c["S0"][-1]) - center(c["S_gt"][-1]))
        after = np.linalg.norm(center(got[-1]) - center(c["S_gt"][-1]))
        assert after < 0.3 * before
    else:
        np.testing.assert_allclose(got, c["S_gt"], atol=SIM3_TOL)


@pytest.mark.parametrize("case", ["drift", "fixed_point"])
def test_normal_equations_equal_dense(ref, case):
    """H and g assembled from the edges' 7 x 14 blocks against the dense
    J^T J and J^T r of the whole problem (J by reverse-mode autodiff against
    all 7K tangents, fixed vertices' columns zero, as the JAX package forms
    it), within f32: 1e-6 of the largest entry."""
    c = ref["graph"][case]
    S, fixed, e = _t(c["S0"]), _t(c["fixed"]), _edges(c["edges"])
    K = S.shape[0]
    sw = torch.sqrt(e.info)
    H, g, _ = t_spg.normal_equations(S, fixed, e.i, e.j, e.S_meas, e.info)
    free = (~fixed).to(S.dtype)

    def resid(d):
        Sn = t_sim3.retract(S, d.reshape(K, 7) * free[:, None])
        return (t_spg.edge_residuals(Sn, e) * sw[:, None]).reshape(-1)

    zero = torch.zeros(7 * K)
    J = torch.func.jacrev(resid)(zero)
    H_dense, g_dense = J.T @ J, J.T @ resid(zero)
    assert H.shape == H_dense.shape == (7 * K, 7 * K)
    assert (H - H_dense).abs().max() <= 1e-6 * H_dense.abs().max()
    assert (g - g_dense).abs().max() <= 1e-6 * max(g_dense.abs().max(), 1e-3)


def test_carry_points_sim3(ref):
    c = ref["carry"]
    got = t_spg.carry_points_sim3(_t(c["points"]), _t(c["ref"]), _t(c["S_old"]),
                                  _t(c["S_new"])).numpy()
    np.testing.assert_allclose(got, c["out"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, t_sim3.transform(_t(c["corr"]), _t(c["points"])).numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# correct_loop and the closer on the loop scene
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fix_scale", [False, True])
def test_correct_loop(ref, fix_scale):
    """Both branches on the closer's recorded inputs (the Sim3 correction that
    JAX's closer made, and the SE3 branch of the same correction)."""
    (args, want), = ref["calls"]["correct_loop"]
    if fix_scale:
        want = ref["correct_loop_se3"]
    cfg = TCFG if fix_scale else TCFG_S
    got = t_lc.correct_loop(_tm(_jm(args[0])), int(args[1]), int(args[2]), _t(args[3]), cfg)
    _maps_agree(convert.map_state_to_numpy(got), _jm(want), lm=True)


@pytest.fixture(scope="module")
def port_closer(ref):
    closer = t_lc.LoopCloser(TCFG_S)
    closer.draws = JaxDraws(99)
    m = _tm(ref["scene"]["m"])
    closed, correcting = [], []
    for cur in (4, 5, 6):
        m, c = closer.process_keyframe(m, cur)
        closed.append(c)
        correcting.append(closer.correcting)
    return closer, convert.map_state_to_numpy(m), closed, correcting


def test_loop_closer_sim3(ref, port_closer):
    """The same keyframe closes the loop on both through the Sim3 branch
    (``correct_loop``, fusion, global BA); the corrected maps agree, but for
    the fusion's write at the current keyframe's feature F-1, which JAX
    loses (ROADMAP, queue 3), and the global BA's outlier flags (at most
    0.1% apart, as in ``test_torch_loop.py``)."""
    closer, got, closed, correcting = port_closer
    assert closed == list(ref["closed"]) == [False, False, True]
    assert correcting == list(ref["correcting"]) == [False, False, False]
    assert closer.last_loop_seq == 17 and closer.consistent_groups == []
    want = _jm(ref["final"])
    if want["kf_mp"][6, F - 1] == -1 and got["kf_mp"][6, F - 1] >= 0:
        got["kf_mp"][6, F - 1] = -1
    _maps_agree(got, want, lm=True, skip=("obs_valid", "bobs_valid"))
    for k in ("obs_valid", "bobs_valid"):
        assert (got[k] != want[k]).mean() <= 1e-3, k


def test_loop_closer_sim3_calls(ref, monkeypatch):
    """The port's ``correct_loop`` is called once, with the recorded
    candidate, and ``correcting`` is true inside the correction only."""
    seen = []
    correct0 = t_lc.correct_loop
    closer = t_lc.LoopCloser(TCFG_S)
    closer.draws = JaxDraws(99)

    def correct(m, cur, cand, S, cfg):
        seen.append((cur, cand, closer.correcting))
        return correct0(m, cur, cand, S, cfg)

    monkeypatch.setattr(t_lc, "correct_loop", correct)
    m = _tm(ref["scene"]["m"])
    for cur in (4, 5):
        assert not closer.process_keyframe(m, cur)[1]
    assert not seen
    (args, _), = ref["calls"]["correct_loop"]
    # the correction itself is held by test_loop_closer_sim3; here only the call
    monkeypatch.setattr(t_lc, "search_and_fuse", lambda m, *a: m)
    monkeypatch.setattr(t_lc, "global_ba", lambda m, cfg: m)
    assert closer.process_keyframe(m, 6)[1]
    assert seen == [(6, int(args[2]), True)] and not closer.correcting
