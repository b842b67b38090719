"""The port's asynchronous mapping on the CPU, against the JAX package and
against its own synchronous mode.

  * ``tracking.replay_bird_points`` against JAX's, exact, on a numpy scene
    (``torch_scenes.slice_scene``): the worker's result culled some bird
    points; the live map gained frame-born ones, one of them in a slot that
    tracking culled and recycled (a ``bp_gen`` change); and the same with
    the result starved of free slots, so that births are dropped;
  * the keyframe journal's replay in ``SlamSystem._consume_pending`` against
    JAX's, on ``tests/test_loop_journal.py``'s two cases (a replayed
    keyframe lands at its reference's corrected pose; its reference died in
    the merge and its cull-time pose is taken): poses within 1e-5, every
    other field equal;
  * the snapshot invariant: with the mapping stage held, every tensor of the
    job's snapshot is unchanged after tracking has run frames on the live map;
  * the facade with ``async_mapping=True``, its pipeline flushed after each
    ``track``, equals the synchronous facade exactly over
    ``tests/test_torch_system.py``'s three frames and configuration:
    every map field, the trajectory entries and their export;
  * the tracer's counts from spans run in two threads at once.

JAX's references are computed once per run (``torch_refs.shared``), with
``insert_keyframe`` compiled at XLA's backend optimisation level 0.
"""

import copy
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_tpu.slam import system as j_system
from fishbirdeyevisualslam_tpu.slam import tracking as j_tr
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.io.session import load_session, save_session
from fishbirdeyevisualslam_torch.io.tracing import Tracer
from fishbirdeyevisualslam_torch.runtime.native import AsyncPipeline
from fishbirdeyevisualslam_torch.slam import tracking as t_tr
from fishbirdeyevisualslam_torch.slam.system import MappingJob, MappingResult, SlamSystem
from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws

import test_torch_system as tsys
import torch_refs
from torch_scenes import TCFG, slice_scene

torch.set_num_threads(1)

XLA_OPTS = {"xla_backend_optimization_level": 0}
POSE_TOL = 1e-5


# ---------------------------------------------------------------------------
# inputs and the JAX references
# ---------------------------------------------------------------------------


def _replay_case(seed: int, starved: bool):
    """(result map, live map, born) as numpy dicts, from slice_scene's map as
    the job's snapshot."""
    rng = np.random.RandomState(seed)
    snap = slice_scene()["m"]
    PB = snap["bp_valid"].shape[0]
    snap["bp_gen"] = rng.randint(0, 3, PB).astype(np.int32)
    valid = np.nonzero(snap["bp_valid"])[0]
    res = copy.deepcopy(snap)
    culled = rng.choice(valid, 10, replace=False)           # the worker's bird cull
    res["bp_valid"][culled] = False
    res["bobs_valid"][culled] = False
    if starved:   # the result's free slots: 5 (slot PB-1 is never handed out)
        free = np.nonzero(~res["bp_valid"][:PB - 1])[0]
        res["bp_valid"][free[5:]] = True
    live = copy.deepcopy(snap)
    kept = np.setdiff1d(valid, culled)
    recycled = kept[0]                       # freed by tracking's cull, then reused
    live["bp_valid"][kept[1:3]] = False
    births = np.concatenate([[recycled], np.nonzero(~snap["bp_valid"][:PB - 1])[0][:20]])
    live["bp_valid"][births] = True
    live["bp_gen"][births] += 1
    live["bp_pos"][births] = rng.randn(len(births), 3).astype(np.float32)
    live["bp_desc"][births] = rng.randint(0, 2**32, (len(births), 8), dtype=np.uint64) \
        .astype(np.uint32)
    bits = (live["bp_desc"][births][..., None] >> np.arange(32, dtype=np.uint32)) & 1
    live["bp_desc_pm1"][births] = bits.reshape(len(births), 256).astype(np.float32) * 2 - 1
    live["bp_ref_kf"][births] = rng.randint(0, 3, len(births))
    live["bp_birth"][births] = 2
    born = live["bp_valid"] & (~snap["bp_valid"] | (live["bp_gen"] != snap["bp_gen"]))
    assert born[recycled] and res["bp_valid"][recycled]
    return dict(res=res, live=live, born=born)


def _jax_map(d):
    return j_ms.MapState(**{k: jnp.asarray(v, jnp.bfloat16 if k.endswith("desc_pm1") else None)
                            for k, v in d.items()})


def _journal_cases():
    """tests/test_loop_journal.py's two cases, with insert_keyframe compiled at
    level 0: inputs and the JAX facade's map after ``_consume_pending``."""
    from test_loop_journal import _mk_map
    from test_recycling import CFG, _tiny_frame
    rng0 = np.random.RandomState(0)
    m0 = j_ms.empty_map(CFG)
    f0 = _tiny_frame(rng0, CFG, n_valid_bird=8)
    a0 = j_tr.TrackObs(jnp.full(CFG.capacity.max_front_kp, -1, jnp.int32),
                       jnp.full(CFG.capacity.max_bird_kp, -1, jnp.int32))
    exe = j_tr.insert_keyframe.lower(m0, f0, a0, j_se3.identity(), CFG, jnp.int32(0),
                                     slot=jnp.int32(0)).compile(XLA_OPTS)

    def insert(m, f, assoc, Tcw, cfg, frame_id, slot=None):
        if slot is None:
            slot = j_tr.free_kf_slot(m)[0]
        return exe(m, f, assoc, jnp.asarray(Tcw), jnp.int32(frame_id), slot=jnp.int32(slot))

    saved = j_tr.insert_keyframe
    j_tr.insert_keyframe = insert
    out = []
    try:
        for seed, dead in ((7, False), (8, True)):
            rng = np.random.RandomState(seed)
            m_live, assoc = _mk_map(4, rng)
            sys_ = j_system.SlamSystem(CFG)
            sys_.map = m_live
            if not dead:
                sys_.last_kf_slot = sys_.last_kf_frame_id = 3
            sys_._refresh_kf_snapshot()
            if dead:   # the correction culled keyframe 3, the entry's reference
                m_corr = m_live._replace(kf_valid=m_live.kf_valid.at[3].set(False),
                                         kf_seq=m_live.kf_seq.at[3].set(-1))
                T_rel = j_se3.exp(jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0]))
            else:      # every keyframe moved by a rigid world transform
                corr = j_se3.exp(jnp.asarray([0.0, 0.0, 0.3, 0.5, -0.2, 0.0]))
                m_corr = m_live._replace(kf_Tcw=jnp.stack(
                    [j_se3.compose(m_live.kf_Tcw[k], j_se3.inverse(corr))
                     for k in range(m_live.K)]))
                T_rel = j_se3.exp(jnp.asarray([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]))
            f_new = _tiny_frame(rng, CFG, n_valid_bird=8)
            Tcw_live = j_se3.compose(T_rel, m_live.kf_Tcw[3])
            entry = dict(Tcw=np.asarray(Tcw_live), frame_id=9, ref_fid=3,
                         T_ref_live=np.asarray(m_live.kf_Tcw[3]))
            sys_._kf_journal.append(dict(f=f_new, assoc=assoc, **entry))
            sys_._pending_result = (m_corr, 3 if not dead else 2, not dead)
            sys_.last_assoc = assoc
            sys_._consume_pending()
            out.append(dict(
                dead=dead, m_live=m_live, m_corr=m_corr, f_new=f_new, entry=entry,
                assoc=dict(mp_idx=assoc.mp_idx, bp_idx=assoc.bp_idx),
                last_kf=(sys_.last_kf_slot, sys_.last_kf_frame_id),
                fid_to_slot=sys_._fid_to_slot(), n_loops_closed=sys_.n_loops_closed,
                dead_poses={k: np.asarray(v) for k, v in sys_._dead_kf_poses.items()},
                last_assoc=dict(mp_idx=sys_.last_assoc.mp_idx, bp_idx=sys_.last_assoc.bp_idx),
                out=sys_.map))
    finally:
        j_tr.insert_keyframe = saved
    import dataclasses as dc
    return out, dc.asdict(CFG)


def _jax_refs():
    replay = []
    for seed, starved in ((0, False), (1, True)):
        c = _replay_case(seed, starved)
        args = (_jax_map(c["res"]), _jax_map(c["live"]), jnp.asarray(c["born"]))
        c["out"] = j_tr.replay_bird_points.lower(*args).compile(XLA_OPTS)(*args)
        replay.append(c)
    journal, cfg = _journal_cases()
    tree = jax.tree.map(np.asarray, dict(replay=replay, journal=journal))
    return dict(cfg=cfg, **tree)


torch_refs.register("torch_async", __file__, _jax_refs, cost=15.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_async")


@pytest.fixture(scope="module")
def system_ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_system")


def _np(m):
    return {k: np.asarray(v).astype(np.float32) if np.asarray(v).dtype.name == "bfloat16"
            else np.asarray(v) for k, v in m._asdict().items()} if hasattr(m, "_asdict") else m


def _maps_equal(got: dict, want: dict, pose_tol=None):
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        if pose_tol is not None and k in ("kf_Tcw",):
            np.testing.assert_allclose(got[k], w, atol=pose_tol, err_msg=k)
        elif pose_tol is not None and w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=pose_tol, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# ---------------------------------------------------------------------------
# replay_bird_points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [0, 1], ids=["recycled slot", "starved"])
def test_replay_bird_points(ref, case):
    c = ref["replay"][case]
    m, live = (convert.map_state_from_numpy(c[k], "cpu") for k in ("res", "live"))
    got, remap, n_drop = t_tr.replay_bird_points(m, live, torch.from_numpy(c["born"]))
    want_m, want_remap, want_drop = c["out"]
    _maps_equal(convert.map_state_to_numpy(got), _np(want_m))
    np.testing.assert_array_equal(remap.numpy(), want_remap)
    assert int(n_drop) == int(want_drop)
    born = c["born"]
    if case == 0:
        assert int(n_drop) == 0 and (remap.numpy()[born] >= 0).all()
    else:
        assert int(n_drop) == born.sum() - 5
    # the worker's culls stay culled; surviving points keep their slot
    keep = c["live"]["bp_valid"] & ~born & c["res"]["bp_valid"]
    np.testing.assert_array_equal(remap.numpy()[keep], np.nonzero(keep)[0])


# ---------------------------------------------------------------------------
# the keyframe journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [0, 1], ids=["corrected reference", "dead reference"])
def test_journal_replay(ref, case):
    c = ref["journal"][case]
    cfg = convert.config_from_dict(ref["cfg"])
    sys_ = SlamSystem(cfg, device="cpu")
    m_live = convert.map_state_from_numpy(c["m_live"], "cpu")
    sys_.map = m_live
    if not c["dead"]:
        sys_.last_kf_slot = sys_.last_kf_frame_id = 3
    sys_._refresh_kf_snapshot()
    assoc = t_tr.TrackObs(*(torch.tensor(c["assoc"][k]) for k in ("mp_idx", "bp_idx")))
    e = c["entry"]
    sys_._kf_journal.append(dict(f=convert.frame_from_numpy(c["f_new"], "cpu"), assoc=assoc,
                                 Tcw=np.array(e["Tcw"]), T_ref_live=np.array(e["T_ref_live"]),
                                 frame_id=int(e["frame_id"]), ref_fid=int(e["ref_fid"])))
    m_corr = convert.map_state_from_numpy(c["m_corr"], "cpu")
    job = MappingJob(m_live, 3, 8, se3.identity(), 10**6, None)
    sys_._pending_result = MappingResult(m_corr, not c["dead"], False, job)
    sys_.last_assoc = assoc
    sys_._consume_pending()
    assert sys_._kf_journal == [] and sys_.n_loops_closed == int(c["n_loops_closed"])
    assert sys_.n_jobs_merged == 1 and sys_.n_journal_kfs_dropped == 0
    assert (sys_.last_kf_slot, sys_.last_kf_frame_id) == tuple(int(x) for x in c["last_kf"])
    assert sys_._fid_to_slot() == {int(k): int(v) for k, v in c["fid_to_slot"].items()}
    slot = sys_._fid_to_slot()[9]
    got = convert.map_state_to_numpy(sys_.map)
    _maps_equal(got, _np(c["out"]), pose_tol=POSE_TOL)
    # the replayed keyframe at its relative pose composed onto the reference's
    # corrected pose, or onto its cull-time pose
    anchor = c["dead_poses"][3] if c["dead"] else _np(c["m_corr"])["kf_Tcw"][3]
    T_rel = se3.compose(torch.from_numpy(c["entry"]["Tcw"]),
                        se3.inverse(torch.from_numpy(c["entry"]["T_ref_live"])))
    np.testing.assert_allclose(got["kf_Tcw"][slot],
                               se3.compose(T_rel, torch.from_numpy(anchor)).numpy(),
                               atol=POSE_TOL)
    for k in ("mp_idx", "bp_idx"):
        np.testing.assert_array_equal(getattr(sys_.last_assoc, k).numpy(), c["last_assoc"][k])


# ---------------------------------------------------------------------------
# the facade (test_torch_system.py's frames and configuration)
# ---------------------------------------------------------------------------


def test_flushed_async_equals_sync(system_ref):
    """Flushed after each frame, the asynchronous facade merges each job at
    the next frame boundary and continues from the refined keyframe: its
    map, trajectory entries and exports equal the synchronous facade's bit
    for bit (``track`` returns a keyframe frame's pose before its mapping)."""
    sys_ = SlamSystem(tsys.SCFG, async_mapping=True, device="cpu")
    sys_.draws = tsys.JaxDraws()
    p = system_ref["port"]
    try:
        for i, fr in enumerate(system_ref["frames"]):
            pose = tsys._track(sys_, fr, system_ref["odom"][i])
            sys_._pipeline.flush()
            if not sys_.trajectory[-1].is_keyframe or i < 2:
                np.testing.assert_array_equal(pose, p["poses"][i])
        sys_.finish()
        assert sys_.n_jobs_submitted == sys_.n_jobs_merged == 1
        assert sys_.n_jobs_aborted == 0 and sys_.n_frames_in_flight == 0
        got = convert.map_state_to_numpy(sys_.map)
        for k, want in p["map"].items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert [e.state for e in sys_.trajectory] == p["states"]
        np.testing.assert_array_equal(np.stack([e.T_rel for e in sys_.trajectory]), p["T_rel"])
        np.testing.assert_array_equal(sys_.frame_trajectory_Twb(), p["Twb"])
        np.testing.assert_array_equal(sys_.keyframe_indices(), p["kf_indices"])
        assert sys_.keyframe_trajectory_tum() == p["tum"]
    finally:
        sys_.close()


def test_snapshot_unchanged_while_tracking(system_ref, tmp_path, monkeypatch):
    """The facade after its initialization (saved, then loaded with
    ``async_mapping=True``) inserts a keyframe on frame 2 and hands it to the
    mapping stage, which is held; tracking then runs two more frames on the
    live map (frame 2's images again, later in time).  Every tensor of the
    job's snapshot is unchanged.  On a third frame the stage is released
    after the frame's merge point and the job finishes before the keyframe
    decision, which asks for a keyframe: the unmerged result keeps the job in
    flight, so no keyframe goes into the live map and no second job is
    submitted before the next frame boundary.  The merge afterwards replays
    tracking's frame-born bird points and the map keeps the last keyframe."""
    a = copy.deepcopy(system_ref["after_init"])
    a.draws = GumbelDraws(3)
    path = str(tmp_path / "s.npz")
    save_session(a, path)
    sys_ = load_session(path, tsys.SCFG, async_mapping=True, device="cpu")
    sys_.draws = tsys.JaxDraws(3)
    gate = threading.Event()
    stage = sys_._mapping_stage
    sys_._pipeline.close()
    sys_._pipeline = AsyncPipeline([lambda st, item: gate.wait(60) and stage(st, item)],
                                   capacity=2)
    try:
        fr, odom = system_ref["frames"][2], system_ref["odom"][2]
        tsys._track(sys_, fr, odom)
        assert sys_.n_jobs_submitted == 1 and sys_._mapping_busy
        (job,) = sys_._mapping_jobs.values()
        before = [t.clone() for t in job.map]
        for k in (1, 2):
            tsys._track(sys_, dict(fr, timestamp=fr["timestamp"] + 0.1 * k), odom)
        assert sys_.n_frames_in_flight == 2
        changed = [name for name, x, y in zip(job.map._fields, before, job.map)
                   if not torch.equal(x, y)]
        assert changed == []
        assert not torch.equal(sys_.map.mp_found, job.map.mp_found)   # tracking did write

        def release_then_need(cfg, **kwargs):
            gate.set()
            sys_._pipeline.flush()
            assert not sys_._mapping_busy and sys_._pending_result is not None
            return True, False

        monkeypatch.setattr(t_tr, "need_new_keyframe", release_then_need)
        tsys._track(sys_, dict(fr, timestamp=fr["timestamp"] + 0.3), odom)
        monkeypatch.undo()
        assert sys_.n_jobs_submitted == 1 and sys_.n_jobs_merged == 0
        assert not sys_.trajectory[-1].is_keyframe and sys_._pending_result is not None
    finally:
        gate.set()
        sys_.finish()
        sys_.close()
    assert sys_.n_jobs_merged == 1 and sys_.n_bird_replay_dropped == 0
    assert sys_._fid_to_slot()[sys_.last_kf_frame_id] == sys_.last_kf_slot


def test_tracer_counts_from_two_threads():
    tr = Tracer()
    n = 2000

    def spans():
        for _ in range(n):
            with tr.span("a"):
                pass
            with tr.span("b"):
                pass

    threads = [threading.Thread(target=spans) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = tr.report()
    assert rep["a"]["count"] == rep["b"]["count"] == 2 * n
    assert copy.deepcopy(tr).report()["a"]["count"] == 2 * n
