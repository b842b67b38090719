"""Parity of the port's place recognition and loop closing with the JAX
package on the CPU: ``ops/bow.py``, ``geometry/sim3.py``,
``solvers/sim3_solver.py:ransac_sim3``, ``solvers/pnp.py``,
``solvers/pose_graph.py`` and ``slam/loop_closing.py``'s detection,
transform, correction, global BA and ``LoopCloser``.

Inputs: the oracles' scenes of ``test_place_recognition.py`` and
``test_loop_gates.py`` rebuilt in numpy, and
``torch_scenes.loop_scene``: a map at the mapping tests' capacity (K=16,
P=1024, PB=512, M=4, F=FB=256) whose keyframes revisit the start of the
drive with a world drift.  JAX's ``LoopCloser`` runs over the three return
keyframes with its loop functions compiled once each at XLA's backend
optimisation level 0 and recorded (arguments and results); the port's
functions are held against each recorded call on the same arguments, and
the port's ``LoopCloser`` runs the same three keyframes with JAX's
``PRNGKey(99)`` draws.  JAX computes everything once per test run
(``torch_refs.shared``).

Tolerances: indices, counts, masks and descriptors equal; BoW scores and
edge weights within 1e-6; similarity and pose results within 1e-4 (se3 log) and points within
1e-4 m + 1e-5 of their value where no LM ran; the RANSACs' inlier sets equal;
after a pose graph, a global BA or the whole correction the f32 spread of
these problems: poses within 2e-4 (se3 log), front points reprojected into
each observing keyframe within 0.02 px, bird points within 5e-3 m.

The fusion of the loop writes ``kf_mp[6, F-1]`` (a free feature of the
current keyframe that a loop landmark hits), the JAX package's dump row:
JAX registers the observation and loses the write; the port writes it
(ROADMAP, queue 3), and every other field is equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.geometry import sim3 as j_sim3
from fishbirdeyevisualslam_tpu.ops import bow as j_bow
from fishbirdeyevisualslam_tpu.ops import orb as j_orb
from fishbirdeyevisualslam_tpu.slam import loop_closing as j_lc
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.solvers import pnp as j_pnp
from fishbirdeyevisualslam_tpu.solvers import pose_graph as j_pg
from fishbirdeyevisualslam_tpu.solvers import sim3_solver as j_sim3s
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.geometry import sim3 as t_sim3
from fishbirdeyevisualslam_torch.ops import bow as t_bow
from fishbirdeyevisualslam_torch.slam import loop_closing as t_lc
from fishbirdeyevisualslam_torch.slam import map_state as t_ms
from fishbirdeyevisualslam_torch.solvers import pnp as t_pnp
from fishbirdeyevisualslam_torch.solvers import pose_graph as t_pg
from fishbirdeyevisualslam_torch.solvers import sim3_solver as t_sim3s

import torch_refs
from torch_scenes import F, TCFG, _project, _vocab_leaves, loop_scene

torch.set_num_threads(1)

JCFG = JaxConfig().replace(capacity=JaxCap(**dataclasses.asdict(TCFG.capacity)))
CAM = TCFG.camera
XLA_OPTS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False,
            "xla_cpu_parallel_codegen_split_count": 1}
ITERS = 128
T_TOL, POSE_TOL, PX_TOL, BIRD_TOL = 1e-4, 2e-4, 0.02, 5e-3


class JaxDraws:
    """A JAX key chain as the port's draws: split once per call, the Gumbel
    noise of the split key (``LoopCloser._next_key`` and a RANSAC)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n: int, n_iters: int, n_points: int):
        self.key, k = jax.random.split(self.key)
        return (torch.from_numpy(np.array(jax.random.gumbel(k, (n_iters, n_points)))),)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _flip_bits(rng, packed, p):
    bits = (packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits ^= (rng.rand(*bits.shape) < p).astype(np.uint32)
    return np.sum(bits << np.arange(32, dtype=np.uint32), axis=-1).astype(np.uint32)


def _inputs():
    rng = np.random.RandomState(0)
    # BoW: six keyframes of vocabulary-leaf descriptors, a noisy copy of one
    base = [_vocab_leaves(np.random.RandomState(20 + i), 128) for i in range(6)]
    bow = dict(kf_desc=np.stack(base), q_desc=_flip_bits(rng, base[3], 0.03),
               kf_valid=rng.rand(6, 128) < 0.95, q_valid=rng.rand(128) < 0.95)
    # similarities
    S = lambda: np.concatenate([t_se3.exp(torch.from_numpy(rng.randn(6).astype(np.float32)
                                                           * 0.5)).numpy(),
                                rng.uniform(0.5, 2.0, 1).astype(np.float32)])
    sim = dict(S1=S(), S2=S(), p=rng.randn(5, 3).astype(np.float32),
               v=(rng.randn(7) * 0.2).astype(np.float32))
    # Sim3 RANSAC: 30% outliers
    n = 100
    p2 = (rng.randn(n, 3) * 5).astype(np.float32)
    T = t_se3.exp(torch.tensor([0.1, -0.3, 0.2, 1.5, -0.5, 0.8]))
    p1 = t_se3.transform(T, torch.from_numpy(p2)).numpy()
    p1[:30] += rng.uniform(2, 10, (30, 3))
    ransac_sim = dict(p1=p1.astype(np.float32), p2=p2, valid=rng.rand(n) < 0.97)
    # PnP: 150 points, 30 outliers, 0.3 px noise
    n = 150
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    Tp = t_se3.exp(torch.tensor([0.05, 0.1, -0.05, 0.3, -0.2, 0.5])).numpy()
    uv = _project(Tp, Xw)[0] + rng.randn(n, 2) * 0.3
    uv[:30] = rng.uniform(0, 900, (30, 2))
    pnp = dict(Xw=Xw, uv=uv.astype(np.float32), valid=np.ones(n, bool),
               w=(rng.rand(n) < 0.7).astype(np.float32))
    scene = loop_scene()
    pose = lambda n: t_se3.exp(torch.from_numpy(rng.randn(n, 6).astype(np.float32))).numpy()
    carry = dict(points=rng.randn(40, 3).astype(np.float32),
                 ref=rng.randint(0, 12, 40).astype(np.int32), old=pose(12), new=pose(12))
    return dict(bow=bow, sim=sim, ransac_sim=ransac_sim, pnp=pnp, carry=carry, loop=scene)


def _as_jax(tree):
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        return jnp.asarray(x, jnp.bfloat16) if name.endswith("desc_pm1") else x
    return jax.tree_util.tree_map_with_path(leaf, tree)


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------


def _small_program(inp):
    """The references of the modules without a map, as one program."""
    out = {}
    pm1 = lambda d: j_orb.bits_to_pm1(((d[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & 1)
                                      .reshape(d.shape[:-1] + (256,)).astype(jnp.uint8))
    b = inp["bow"]
    kf_words = jax.vmap(lambda d: j_bow.word_ids(pm1(d)))(b["kf_desc"])
    q_words = j_bow.word_ids(pm1(b["q_desc"]))
    out["bow"] = dict(kf_words=kf_words, q_words=q_words,
                      gate=j_bow.node_gate_mask(q_words, b["q_valid"], kf_words[3], b["kf_valid"][3]),
                      vector=j_bow.bow_vector(q_words, b["q_valid"]),
                      scores=j_bow.score_against_keyframes(q_words, b["q_valid"], kf_words,
                                                           b["kf_valid"]))
    s = inp["sim"]
    out["sim"] = dict(compose=j_sim3.compose(s["S1"], s["S2"]), inverse=j_sim3.inverse(s["S1"]),
                      transform=j_sim3.transform(s["S1"], s["p"]), log=j_sim3.log(s["S1"]),
                      exp=j_sim3.exp(s["v"]), retract=j_sim3.retract(s["S1"], s["v"]),
                      to_se3=j_sim3.to_se3(s["S1"]), from_se3=j_sim3.from_se3(s["S1"][:7]))
    r = inp["ransac_sim"]
    key = jax.random.PRNGKey(8)
    out["ransac_sim3"] = {fs: j_sim3s.ransac_sim3(r["p1"], r["p2"], r["valid"], key,
                                                   fix_scale=fs) for fs in (True, False)}
    out["horn"] = {fs: j_sim3s.horn_alignment(2.0 * r["p1"][30:], r["p2"][30:], fix_scale=fs)
                   for fs in (True, False)}
    out["ransac_sim3_draws"] = jax.random.gumbel(key, (ITERS, r["p1"].shape[0]))
    p = inp["pnp"]
    key = jax.random.PRNGKey(10)
    out["ransac_pnp"] = j_pnp.ransac_pnp(JCFG.camera, p["Xw"], p["uv"], p["valid"], key)
    out["ransac_pnp_draws"] = jax.random.gumbel(key, (ITERS, p["Xw"].shape[0]))
    out["epnp"] = {m: j_pnp._epnp_pose(JCFG.camera, p["Xw"][30:30 + m], p["uv"][30:30 + m])
                   for m in (6, 20)}
    out["epnp_weighted"] = j_pnp._epnp_pose(JCFG.camera, p["Xw"], p["uv"], w=p["w"])
    lm = j_ms.MapState(**inp["loop"]["m"])
    loop_T = j_se3.compose(lm.kf_Tcw[6], j_se3.inverse(lm.kf_Tcw[1]))[None]
    out["edges"] = j_pg.build_pose_graph_edges(
        JCFG, lm.kf_Tcw, j_ms.covisibility_counts(lm), j_ms.bird_covisibility_counts(lm),
        lm.kf_valid, jnp.asarray([6], jnp.int32), jnp.asarray([1], jnp.int32), loop_T,
        min_feat=JCFG.ba.essential_graph_min_feat, kf_seq=lm.kf_seq)
    c = inp["carry"]
    out["carry"] = j_pg.carry_points(c["points"], c["ref"], c["old"], c["new"])
    return out


def _compile(fn, *args):
    """``fn`` (jitted, static arguments among ``args``) compiled at level 0;
    returns it as a function of its dynamic arguments."""
    return fn.lower(*args).compile(XLA_OPTS)


LOOP_FNS = ("detect_loop_groups", "compute_loop_transform", "verify_loop_projection",
            "seed_loop_correction", "search_and_fuse", "loop_essential_graph", "global_ba")


def _loop_closer(m, calls):
    """JAX's ``LoopCloser`` over the three return keyframes, its loop
    functions compiled at level 0 and recorded into ``calls`` (name -> list
    of (dynamic arguments, result))."""
    i32 = jnp.int32
    T = jnp.zeros(7, jnp.float32)
    exe = {
        "detect_loop_groups": _compile(j_lc.detect_loop_groups, m, i32(4), JCFG),
        "compute_loop_transform": _compile(j_lc.compute_loop_transform, m, i32(6), i32(0), JCFG,
                                           jax.random.PRNGKey(0)),
        "verify_loop_projection": _compile(j_lc.verify_loop_projection, m, i32(6), i32(0), T,
                                           JCFG),
        "seed_loop_correction": _compile(j_lc.seed_loop_correction, m, i32(6), i32(0), T, JCFG),
        "search_and_fuse": _compile(j_lc.search_and_fuse, m, i32(6), i32(0), JCFG),
        "loop_essential_graph": _compile(j_lc.loop_essential_graph, m, i32(6), i32(0), m.kf_Tcw,
                                         JCFG),
        "global_ba": _compile(j_lc.global_ba, m, JCFG),
    }
    saved = {name: getattr(j_lc, name) for name in LOOP_FNS}

    def recorder(name):
        def call(*args, **kwargs):
            dyn = [a for a in args if not isinstance(a, JaxConfig)]
            res = exe[name](*dyn)
            calls.setdefault(name, []).append((dyn, res))
            return res
        return call

    try:
        for name in LOOP_FNS:
            setattr(j_lc, name, recorder(name))
        closer = j_lc.LoopCloser(JCFG)
        closed = []
        for cur in (4, 5, 6):
            m, c = closer.process_keyframe(m, cur)
            closed.append(c)
    finally:
        for name, fn in saved.items():
            setattr(j_lc, name, fn)
    return m, closed


def _jax_refs():
    raw = _inputs()
    inp = _as_jax(raw)
    out = jax.jit(_small_program).lower(inp).compile(XLA_OPTS)(inp)
    m = j_ms.MapState(**inp["loop"]["m"])
    calls = {}
    final, closed = _loop_closer(m, calls)
    out["loop_final"], out["loop_closed"] = final, closed
    out["loop_calls"] = calls
    # the fusion into the current keyframe alone, on the seeded map, and the
    # single-shot correction of the same loop
    (seed_args, seeded) = calls["seed_loop_correction"][0]
    cand = seed_args[2]
    C = j_ms.covisibility_counts(seeded)
    grp = ((C[cand] > 0) | (jnp.arange(seeded.K) == cand)) & seeded.kf_valid
    loop_pts = jnp.any(grp[seeded.obs_kf] & seeded.obs_valid, axis=1) & seeded.mp_valid
    fuse = _compile(j_lc._fuse_points_into_kf, seeded, loop_pts, jnp.int32(6), JCFG, True)
    out["fuse"] = dict(m=seeded, pts=loop_pts, out=fuse(seeded, loop_pts, jnp.int32(6), True))
    out["odom_consistent"] = _odom_cases()
    return dict(inputs=raw, **jax.tree.map(np.asarray, out))


def _line_map(n=24, step=1.0):
    """``test_loop_gates.py``'s keyframes along +x with odometry at the truth
    (a capacity of 32 keyframes)."""
    from fishbirdeyevisualslam_tpu.geometry import ipm as j_ipm
    K = 32
    x = jnp.arange(K, dtype=jnp.float32) * step
    Twb = jnp.stack([jnp.ones(K), *([jnp.zeros(K)] * 3), x, jnp.zeros(K), jnp.zeros(K)], -1)
    valid = jnp.arange(K) < n
    return dict(kf_Tcw=j_ipm.Tcw_from_Twb(JaxConfig().extrinsics, Twb), kf_valid=valid,
                kf_seq=jnp.where(valid, jnp.arange(K), -1).astype(jnp.int32),
                kf_odom=jnp.stack([x, jnp.zeros(K), jnp.zeros(K)], -1))


ODOM_CASES = (  # (keyframes, step, current, candidate, x-shift of the correction)
    (24, 1.0, 20, 2, 0.0), (24, 1.0, 20, 2, 15.0), (21, 10.0, 20, 0, 2.0), (24, 1.0, 20, 2, 1.0))


def _odom_cases():
    """``LoopCloser._odom_consistent`` on ``test_loop_gates.py``'s cases: the
    maps (default capacity) as numpy, the corrections and JAX's verdicts."""
    closer = j_lc.LoopCloser(JaxConfig())
    out = []
    for n, step, cur, cand, dx in ODOM_CASES:
        m = _line_map(n, step)
        T = jnp.asarray([1.0, 0, 0, 0, dx, 0.0, 0.0], jnp.float32)
        ok = closer._odom_consistent(j_ms.MapState(**{f: m.get(f) for f in j_ms.MapState._fields}),
                                     cur, cand, T)
        out.append(dict(m=m, T=T, ok=bool(ok)))
    return out


torch_refs.register("torch_loop", __file__, _jax_refs, cost=40.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_loop")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.array(x))


def _tm(d):
    return convert.map_state_from_numpy(d, "cpu")


def _jm(m) -> dict:
    """A recorded JAX MapState as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _pose_err(a, b):
    a, b = _t(a).reshape(-1, 7), _t(b).reshape(-1, 7)
    return t_se3.log(t_se3.compose(a, t_se3.inverse(b))).abs().max().item()


def _pm1(d):
    bits = (d[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return torch.from_numpy(bits.reshape(d.shape[:-1] + (256,)).astype(np.float32) * 2 - 1) \
        .to(torch.bfloat16)


def _maps_agree(got, want, skip=(), pos_tol=1e-4, lm=False):
    """Every field of two maps (dicts of numpy) equal, floats within
    ``pos_tol`` + 1e-5 relative; with ``lm`` (after an LM) poses within
    POSE_TOL, front points within PX_TOL in their observing keyframes and
    bird points within BIRD_TOL."""
    for k, w in want.items():
        if k in skip or (lm and k in ("kf_Tcw", "mp_pos", "bp_pos")):
            continue
        g = got[k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=pos_tol, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if lm:
        valid = want["kf_valid"]
        assert _pose_err(got["kf_Tcw"][valid], want["kf_Tcw"][valid]) <= POSE_TOL
        ok = want["obs_valid"] & want["mp_valid"][:, None]
        p, s = np.nonzero(ok)
        kf = want["obs_kf"][p, s]
        uv_g = _project(want["kf_Tcw"][kf], got["mp_pos"][p])[0]
        uv_w = _project(want["kf_Tcw"][kf], want["mp_pos"][p])[0]
        assert np.abs(uv_g - uv_w).max() <= PX_TOL
        bv = want["bp_valid"]
        assert np.abs(got["bp_pos"][bv] - want["bp_pos"][bv]).max() <= BIRD_TOL


# ---------------------------------------------------------------------------
# BoW, Sim3, RANSACs, PnP, the pose graph
# ---------------------------------------------------------------------------


def test_bow(ref):
    b, w = ref["inputs"]["bow"], ref["bow"]
    kf_words = torch.stack([t_bow.vocab.word_ids(_pm1(d)) for d in b["kf_desc"]])
    q_words = t_bow.vocab.word_ids(_pm1(b["q_desc"]))
    np.testing.assert_array_equal(kf_words.numpy(), w["kf_words"])
    np.testing.assert_array_equal(q_words.numpy(), w["q_words"])
    qv, kv = _t(b["q_valid"]), _t(b["kf_valid"])
    np.testing.assert_array_equal(t_bow.node_gate_mask(q_words, qv, kf_words[3], kv[3]).numpy(),
                                  w["gate"])
    np.testing.assert_allclose(t_bow.bow_vector(q_words, qv).numpy(), w["vector"], atol=1e-6)
    scores = t_bow.score_against_keyframes(q_words, qv, kf_words, kv).numpy()
    np.testing.assert_allclose(scores, w["scores"], atol=1e-6)
    assert scores.argmax() == 3 and scores[3] > 2 * np.delete(scores, 3).max()


@pytest.mark.parametrize("op", ["compose", "inverse", "transform", "log", "exp", "retract",
                                "to_se3", "from_se3"])
def test_sim3(ref, op):
    s = {k: _t(v) for k, v in ref["inputs"]["sim"].items()}
    got = {"compose": lambda: t_sim3.compose(s["S1"], s["S2"]),
           "inverse": lambda: t_sim3.inverse(s["S1"]),
           "transform": lambda: t_sim3.transform(s["S1"], s["p"]),
           "log": lambda: t_sim3.log(s["S1"]), "exp": lambda: t_sim3.exp(s["v"]),
           "retract": lambda: t_sim3.retract(s["S1"], s["v"]),
           "to_se3": lambda: t_sim3.to_se3(s["S1"]),
           "from_se3": lambda: t_sim3.from_se3(s["S1"][:7])}[op]()
    np.testing.assert_allclose(got.numpy(), ref["sim"][op], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3(ref, fix_scale):
    r = {k: _t(v) for k, v in ref["inputs"]["ransac_sim"].items()}
    w = ref["ransac_sim3"][fix_scale]
    got = t_sim3s.ransac_sim3(r["p1"], r["p2"], r["valid"], _t(ref["ransac_sim3_draws"]),
                              fix_scale=fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(), w.inliers)
    assert int(got.n_inliers) == int(w.n_inliers) and bool(got.success) == bool(w.success)
    assert _pose_err(t_sim3.to_se3(got.S12), t_sim3.to_se3(_t(w.S12))) <= T_TOL
    assert abs(float(got.S12[7]) - float(w.S12[7])) <= 1e-4
    assert not got.inliers[:30].any() and got.inliers[30:].float().mean() > 0.9
    h = t_sim3s.horn_sim3(2.0 * r["p1"][30:], r["p2"][30:], fix_scale=fix_scale)
    np.testing.assert_allclose(h.numpy(), ref["horn"][fix_scale], atol=1e-4, rtol=1e-5)


def test_ransac_pnp(ref):
    p = {k: _t(v) for k, v in ref["inputs"]["pnp"].items()}
    w = ref["ransac_pnp"]
    got = t_pnp.ransac_pnp(CAM, p["Xw"], p["uv"], p["valid"], _t(ref["ransac_pnp_draws"]))
    np.testing.assert_array_equal(got.inliers.numpy(), w.inliers)
    assert int(got.n_inliers) == int(w.n_inliers) and bool(got.success)
    assert _pose_err(got.Tcw, w.Tcw) <= T_TOL


@pytest.mark.parametrize("case", ["6 points", "20 points", "weighted"])
def test_epnp_pose(ref, case):
    p = {k: _t(v) for k, v in ref["inputs"]["pnp"].items()}
    if case == "weighted":
        got, want = t_pnp._epnp_pose(CAM, p["Xw"], p["uv"], w=p["w"]), ref["epnp_weighted"]
    else:
        n = int(case.split()[0])
        got = t_pnp._epnp_pose(CAM, p["Xw"][30:30 + n], p["uv"][30:30 + n])
        want = ref["epnp"][n]
    assert _pose_err(got, want) <= T_TOL


def test_carry_points(ref):
    c = {k: _t(v) for k, v in ref["inputs"]["carry"].items()}
    got = t_pg.carry_points(c["points"], c["ref"], c["old"], c["new"])
    np.testing.assert_allclose(got.numpy(), ref["carry"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# loop detection, transform and correction, each on JAX's recorded inputs
# ---------------------------------------------------------------------------


def _calls(ref, name):
    return ref["loop_calls"][name]


def test_detect_loop_groups(ref):
    """Three keyframes' retrievals; the scores of the last against JAX's."""
    m = _tm(ref["inputs"]["loop"]["m"])
    for args, want in _calls(ref, "detect_loop_groups"):
        got = t_lc.detect_loop_groups(_tm(_jm(args[0])), int(args[1]), TCFG)
        np.testing.assert_array_equal(got.best_member.numpy(), want[0])
        np.testing.assert_allclose(got.acc.numpy(), want[1], atol=1e-5)
        np.testing.assert_array_equal(got.groups.numpy(), want[2])
        np.testing.assert_allclose(float(got.min_score), float(want[3]), atol=1e-6)
    scores, min_score, eligible = t_lc.detect_loop_scores(m, 6, TCFG)
    assert eligible[:4].all() and not eligible[4:].any()
    assert float(scores[:4].min()) > float(min_score)


def test_compute_loop_transform(ref):
    draws = JaxDraws(99)
    for args, want in _calls(ref, "compute_loop_transform"):
        m = _tm(_jm(args[0]))
        gumbel = draws(1, ITERS, 2 * F)[0]
        S, n_in, ok = t_lc.compute_loop_transform(m, int(args[1]), int(args[2]), TCFG, gumbel)
        assert bool(ok) == bool(want[2]) and int(n_in) == int(want[1])
        assert _pose_err(t_sim3.to_se3(S), t_sim3.to_se3(_t(want[0]))) <= T_TOL
    # the correction undoes the scene's drift
    D = ref["inputs"]["loop"]["D"]
    assert _pose_err(t_sim3.to_se3(S), D) < 0.05


def test_verify_loop_projection(ref):
    (args, want), = _calls(ref, "verify_loop_projection")
    got = t_lc.verify_loop_projection(_tm(_jm(args[0])), int(args[1]), int(args[2]),
                                      _t(args[3]), TCFG)
    assert int(got) == int(want) and int(want) >= TCFG.tracking.loop_min_proj_matches


def test_seed_loop_correction(ref):
    (args, want), = _calls(ref, "seed_loop_correction")
    got = t_lc.seed_loop_correction(_tm(_jm(args[0])), int(args[1]), int(args[2]),
                                    _t(args[3]), TCFG)
    _maps_agree(convert.map_state_to_numpy(got), _jm(want), pos_tol=1e-5)


def test_fuse_points_into_kf_feature_f_minus_1(ref):
    """The free hit on keyframe 6's feature F-1: JAX registers the
    observation but leaves ``kf_mp[6, F-1] = -1``; the port writes it."""
    fz = ref["fuse"]
    got = convert.map_state_to_numpy(
        t_lc._fuse_points_into_kf(_tm(_jm(fz["m"])), _t(fz["pts"]), 6, TCFG))
    want = _jm(fz["out"])
    pt = got["kf_mp"][6, F - 1]
    assert want["kf_mp"][6, F - 1] == -1 and pt >= 0
    assert np.any((want["obs_kf"][pt] == 6) & (want["obs_feat"][pt] == F - 1)
                  & want["obs_valid"][pt])
    got["kf_mp"][6, F - 1] = -1
    _maps_agree(got, want, pos_tol=0)
    # the fusion merged duplicates of the two visits
    assert want["mp_valid"].sum() < _jm(fz["m"])["mp_valid"].sum()


def test_search_and_fuse(ref):
    (args, want), = _calls(ref, "search_and_fuse")
    got = convert.map_state_to_numpy(
        t_lc.search_and_fuse(_tm(_jm(args[0])), int(args[1]), int(args[2]), TCFG))
    want = _jm(want)
    assert want["kf_mp"][6, F - 1] == -1 and got["kf_mp"][6, F - 1] >= 0
    got["kf_mp"][6, F - 1] = -1
    _maps_agree(got, want, pos_tol=0)


def test_loop_essential_graph(ref):
    (args, want), = _calls(ref, "loop_essential_graph")
    got = t_lc.loop_essential_graph(_tm(_jm(args[0])), int(args[1]), int(args[2]), _t(args[3]),
                                    TCFG)
    _maps_agree(convert.map_state_to_numpy(got), _jm(want), lm=True)


def test_build_pose_graph_edges(ref):
    """The essential graph's edges on the loop map: the spanning tree, the
    strong covisibility pairs, the bird fallback and a loop edge (6, 1)."""
    m = _tm(ref["inputs"]["loop"]["m"])
    loop_T = t_se3.compose(m.kf_Tcw[6], t_se3.inverse(m.kf_Tcw[1]))[None]
    one = lambda k: torch.tensor([k], dtype=torch.int32)
    e = t_pg.build_pose_graph_edges(TCFG, m.kf_Tcw, t_ms.covisibility_counts(m),
                                    t_ms.bird_covisibility_counts(m), m.kf_valid, m.kf_seq,
                                    one(6), one(1), loop_T)
    for g, w in zip(e, ref["edges"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)
    assert int(e.valid.sum()) >= TCFG.capacity.max_keyframes // 2


def test_global_ba(ref):
    (args, want), = _calls(ref, "global_ba")
    got = t_lc.global_ba(_tm(_jm(args[0])), TCFG)
    _maps_agree(convert.map_state_to_numpy(got), _jm(want), lm=True)


@pytest.mark.parametrize("case", range(len(ODOM_CASES)))
def test_odom_consistent(ref, case):
    c = ref["odom_consistent"][case]
    m = t_ms.empty_map(TCFG, device="cpu")._replace(**{k: _t(v) for k, v in c["m"].items()})
    _, _, cur, cand, _ = ODOM_CASES[case]
    closer = t_lc.LoopCloser(TCFG)
    disagreement, tolerance = closer._odom_vet(m, cur, cand, _t(c["T"]))
    assert (disagreement <= tolerance) == c["ok"]
    assert [x["ok"] for x in ref["odom_consistent"]][:3] == [True, False, True]


# ---------------------------------------------------------------------------
# LoopCloser over the three return keyframes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_closer(ref):
    closer = t_lc.LoopCloser(TCFG)
    closer.draws = JaxDraws(99)
    m = _tm(ref["inputs"]["loop"]["m"])
    closed, seeded = [], []
    seed0 = t_lc.seed_loop_correction

    def seed(m, cur, cand, T, cfg):
        seeded.append(cand)
        return seed0(m, cur, cand, T, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_lc, "seed_loop_correction", seed)
        for cur in (4, 5, 6):
            m, c = closer.process_keyframe(m, cur)
            closed.append(c)
    return closer, convert.map_state_to_numpy(m), closed, seeded


def test_loop_closer(ref, port_closer):
    """The same keyframes close the loop on both (the third, after three
    consistent groups), with the same candidate; the corrected maps agree."""
    closer, got, closed, seeded = port_closer
    assert closed == list(ref["loop_closed"]) == [False, False, True]
    (args, _), = _calls(ref, "seed_loop_correction")
    assert seeded == [int(args[2])]
    assert closer.last_loop_seq == 17 and closer.consistent_groups == []
    want = _jm(ref["loop_final"])
    assert want["kf_mp"][6, F - 1] == -1 and got["kf_mp"][6, F - 1] >= 0
    got["kf_mp"][6, F - 1] = -1
    _maps_agree(got, want, lm=True, skip=("obs_valid", "bobs_valid"))
    for k in ("obs_valid", "bobs_valid"):   # the global BA's outlier flags
        assert (got[k] != want[k]).mean() <= 1e-3, k


def test_loop_closer_corrects_the_drift(ref, port_closer):
    """The return keyframes end within 5 cm and 0.01 rad of their true poses
    (the drift was 0.47 m and 0.03 rad)."""
    _, got, _, _ = port_closer
    m0 = ref["inputs"]["loop"]["m"]
    D = _t(ref["inputs"]["loop"]["D"])
    true = t_se3.compose(_t(m0["kf_Tcw"][4:7]), t_se3.inverse(D))
    err = t_se3.log(t_se3.compose(_t(got["kf_Tcw"][4:7]), t_se3.inverse(true))).abs()
    assert err[:, :3].max() < 0.01 and err[:, 3:].max() < 0.05, err


def test_loop_detect_span(ref):
    """The closer reports its detection cost through the facade's tracer."""
    from fishbirdeyevisualslam_torch.io.tracing import Tracer
    closer = t_lc.LoopCloser(TCFG)
    closer.tracer = Tracer()
    closer.process_keyframe(_tm(ref["inputs"]["loop"]["m"]), 4)
    assert closer.tracer.report()["loop_detect"]["count"] == 1


def test_loop_closer_sim3_branch_raises(ref, monkeypatch):
    """With ``fix_scale = False`` the loop is found as before, and its Sim3
    correction (ported since: ``correct_loop``'s Sim3 branch, the fusion,
    global BA) closes it and raises nothing; its parity with JAX is
    ``tests/test_torch_sim3.py``'s."""
    cfg = TCFG.replace(flags=dataclasses.replace(TCFG.flags, fix_scale=False))
    closer = t_lc.LoopCloser(cfg)
    transforms, vets = [], []
    transform0, vet0 = t_lc.compute_loop_transform, t_lc.LoopCloser._odom_vet
    monkeypatch.setattr(t_lc, "compute_loop_transform",
                        lambda *a: transforms.append(transform0(*a)) or transforms[-1])
    monkeypatch.setattr(t_lc.LoopCloser, "_odom_vet",
                        lambda self, *a: vets.append(vet0(self, *a)) or vets[-1])
    m = _tm(ref["inputs"]["loop"]["m"])
    for cur in (4, 5):
        assert not closer.process_keyframe(m, cur)[1]
    m6, closed = closer.process_keyframe(m, 6)
    assert closed and not closer.correcting and closer.last_loop_seq == 17
    assert bool(transforms[-1][2]) and vets[-1][0] <= vets[-1][1]
    assert not torch.equal(m6.kf_Tcw, m.kf_Tcw)
