"""The port's ``SlamSystem`` against the JAX package's, on the CPU: the first
three frames of a rendered arc drive at 0.5 m per frame (a reference frame,
the frame that initializes, and a tracked frame that inserts a keyframe and
runs ``local_mapping_step``), loop closing off on the JAX facade and on by
default on the port's (its detection finds no loop in three frames).

Capacity: the mapping tests' K=16, P=1024, PB=512, with F=FB=512 keypoints
and an initialization budget of 1024 (the facade doubles the front budget
until it initializes, then cuts the init pair back to F).  At F=FB=256 the
tracked frame keeps 5 inliers and both facades reset; 512 is the smallest
capacity at which it inserts its keyframe.

The port's facade runs as a user calls it, on frames rendered by its copy of
``io/synthetic.py``, with the JAX facade's RANSAC draws, replayed from its
``PRNGKey(7)`` key chain.  The JAX facade runs once per test run, meanwhile,
in a process of its own (``tests/torch_system_jax.py``, compiled at XLA's
backend optimisation level 0 without fusion emitters, which its jitted
functions cannot take as options), on the port's Frames: each Frame the
port's facade builds is handed to it as it is built, in place of its own
frame build.  The extraction's parity is ``tests/test_torch_extract.py``'s,
and the JAX frame build at full image size would cost more compile CPU than
the rest of the JAX facade.  Both facades ask for the same frames at the same
budgets; states, keyframe indices, TUM timestamps and the map's counts after
each frame equal; every pose within 1e-3 (se3 log; measured 1.6e-05).

Sessions (``io/session.py``): the JAX facade saves its session after its
frames, and the port loads it field for field; the port's facade saved
after two frames and resumed equals the uninterrupted run exactly.

The port runs on one CPU thread, and the render on one BLAS thread.
"""

import copy
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.io import synthetic
from fishbirdeyevisualslam_torch.io.evaluate import parse_tum
from fishbirdeyevisualslam_torch.slam import system
from fishbirdeyevisualslam_torch.slam import tracking as tr
from fishbirdeyevisualslam_torch.slam.system import SlamSystem
from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws

import torch_refs
from torch_scenes import TCFG

torch.set_num_threads(1)

SCFG = TCFG.replace(capacity=dataclasses.replace(TCFG.capacity, max_front_kp=512, max_bird_kp=512),
                    orb=dataclasses.replace(TCFG.orb, n_features_init=1024))
N_FRAMES = 3
POSE_TOL = 1e-3
HERE = Path(__file__).resolve().parent
# the JAX facade's compile: XLA's backend at optimisation level 0, its
# elemental emitters, one LLVM module per program, one thread for Eigen and BLAS
JAX_ENV = {"XLA_FLAGS": "--xla_backend_optimization_level=0 --xla_cpu_use_fusion_emitters=false "
                        "--xla_cpu_parallel_codegen_split_count=1 "
                        "--xla_cpu_multi_thread_eigen=false",
           "OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


class JaxDraws:
    """The JAX facade's RANSAC noise: its key chain from ``PRNGKey(7)``, split
    once per initializer call; ``initialize`` splits its key again for the F
    and the H RANSAC."""

    def __init__(self, seed: int = 7):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n: int, n_iters: int, n_points: int):
        self.key, k = jax.random.split(self.key)
        keys = jax.random.split(k) if n == 2 else [k]
        return tuple(torch.from_numpy(np.array(jax.random.gumbel(kk, (n_iters, n_points))))
                     for kk in keys)


def _track(sys_, fr, odom):
    return sys_.track(fr["front"], fr["bird"], fr["mask"], odom, fr["timestamp"])


def _counts(m):
    return {"kf_valid": int(m.kf_valid.sum()), "n_kf": int(m.n_kf),
            "mp_valid": int(m.mp_valid.sum()), "bp_valid": int(m.bp_valid.sum())}


def _dump(path, value):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(path + ".tmp", path)


def _run(frames, odom, on_frame):
    """The port's facade over ``frames`` with the JAX facade's draws; hands
    ``on_frame(k, frame's number, its front budget, the Frame as numpy)``
    each Frame it builds, in order.  Returns its outputs, the (frame, budget)
    of each Frame it built and the facade right after its initialization (its
    draws used up)."""
    build_frame, built, current = system.build_frame, [], [0]

    def recording_build_frame(*args, **kwargs):
        f = build_frame(*args, **kwargs)
        built.append((current[0], int(f.uv.shape[0])))
        on_frame(len(built) - 1, *built[-1], convert.frame_to_numpy(f))
        return f

    system.build_frame = recording_build_frame
    try:
        sys_ = SlamSystem(SCFG, device="cpu")
        sys_.draws = JaxDraws()
        poses, counts, after_init = [], [], None
        for i, fr in enumerate(frames):
            current[0] = i
            poses.append(_track(sys_, fr, odom[i]))
            counts.append(None if sys_.map is None else _counts(sys_.map))
            if i == 1:
                after_init = copy.deepcopy(sys_)
                after_init.draws = None
    finally:
        system.build_frame = build_frame
    out = dict(poses=np.stack(poses), states=[e.state for e in sys_.trajectory],
               kf_indices=sys_.keyframe_indices(), Twb=sys_.frame_trajectory_Twb(),
               tum=sys_.keyframe_trajectory_tum(), inits=sys_.inits, counts=counts,
               map=convert.map_state_to_numpy(sys_.map),
               T_rel=np.stack([e.T_rel for e in sys_.trajectory]))
    return out, built, after_init


def _refs():
    """Starts the JAX facade's process, renders the drive meanwhile, runs the
    port's facade on it, handing the JAX facade each Frame as the port builds
    it, and collects both."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(HERE.parent), **JAX_ENV)
        proc = subprocess.Popen([sys.executable, str(HERE / "torch_system_jax.py"), tmp,
                                 str(N_FRAMES)], env=env)
        try:
            _dump(os.path.join(tmp, "config.pkl"), dataclasses.asdict(SCFG))
            with threadpool_limits(1):
                seq = synthetic.make_sequence(SCFG, n_frames=N_FRAMES, kind="arc", step=0.5,
                                              seed=0)
            frames = [{k: fr[k] for k in ("front", "bird", "mask", "timestamp")}
                      for fr in seq.frames]
            odom = np.asarray(seq.odom)
            port, built, after_init = _run(frames, odom, lambda k, i, n, f: _dump(
                os.path.join(tmp, f"frame_{k}.pkl"), dict(index=i, n_front=n, frame=f)))
            assert proc.wait(timeout=600) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
            jax_out = pickle.load(f)
        with open(os.path.join(tmp, "session.npz"), "rb") as f:
            jax_out["session"] = f.read()
    return dict(frames=frames, odom=odom, port=port, built=built, jax=jax_out,
                after_init=after_init)


torch_refs.register("torch_system", __file__, _refs, cost=60.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_system")


def _pose_errs(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return se3.log(se3.compose(a, se3.inverse(b))).abs().amax(-1).numpy()


def _poses_agree(got, want):
    err = _pose_errs(got, want)
    assert err.shape == (N_FRAMES,)
    assert err.max() <= POSE_TOL, err


def test_frames(ref):
    """Both facades ask for the same frames at the same budgets: the front
    budget doubles until they initialize."""
    assert ref["built"] == [(0, 1024), (1, 1024), (2, 512)]
    assert ref["jax"]["requests"] == ref["built"]


def test_states_and_keyframes(ref):
    j, p = ref["jax"], ref["port"]
    assert j["states"] == [tr.NOT_INITIALIZED, tr.OK, tr.OK]
    assert p["states"] == j["states"]
    np.testing.assert_array_equal(p["kf_indices"], j["kf_indices"])
    assert p["inits"][0]["frame"] == 1


@pytest.mark.parametrize("which", ["track", "frame_trajectory_Twb"])
def test_poses(ref, which):
    key = "poses" if which == "track" else "Twb"
    j, p = ref["jax"], ref["port"]
    assert p[key].shape == j[key].shape == (N_FRAMES, 7)
    _poses_agree(p[key], j[key])


def test_map_counts(ref):
    assert ref["port"]["counts"][0] is None and ref["jax"]["counts"][0] is None
    assert ref["port"]["counts"][1:] == ref["jax"]["counts"][1:]


def test_tum_export(ref):
    a, b = parse_tum(ref["port"]["tum"]), parse_tum(ref["jax"]["tum"])
    assert a.shape == b.shape == (len(ref["jax"]["kf_indices"]), 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    # TUM rows are (t, x, y, z, qx, qy, qz, qw): back to (qw, qx, qy, qz, x, y, z)
    T = lambda r: np.concatenate([r[:, 7:8], r[:, 4:7], r[:, 1:4]], 1).astype(np.float32)
    _poses_agree(T(a), T(b))   # the keyframes are frames 0, 1 and 2


def _frame(ref, i, blank=False):
    fr = dict(ref["frames"][i])
    if blank:  # no texture: nothing to match
        fr["front"] = np.full_like(fr["front"], 128.0)
    return fr


@pytest.mark.parametrize("case", ["async mapping", "loop closing", "fallback under 10 matches",
                                  "lost"])
def test_branches_outside_the_port_raise(ref, case):
    """Every branch of the JAX facade is ported and runs: asynchronous
    mapping (its native pipeline built; its parity is
    ``tests/test_torch_async.py``'s), loop closing (on by default, as in the
    JAX package), the fallback under 10 motion-model matches and the LOST
    state."""
    if case == "async mapping":
        sys_ = SlamSystem(SCFG, async_mapping=True, device="cpu")
        assert sys_._pipeline.is_native and sys_._mapping_stream is None
        sys_.close()
        assert sys_.n_jobs_submitted == 0
        return
    sys_ = copy.deepcopy(ref["after_init"])
    sys_.draws = JaxDraws(1)
    odom = ref["odom"][2]
    if case == "loop closing":   # frame 2 inserts a keyframe: detection runs, finds no loop
        assert SlamSystem(SCFG, device="cpu").enable_loop_closing
        _track(sys_, _frame(ref, 2), odom)
        assert sys_.tracer.report()["loop_detect"]["count"] == 1
        assert sys_.n_loops_closed == 0 and sys_.trajectory[-1].is_keyframe
    elif case == "fallback under 10 matches":
        # nothing to match: the fallback finds nothing either, and a map of
        # two keyframes is reset (Tracking.cc:731-740)
        _track(sys_, _frame(ref, 2, blank=True), odom)
        assert sys_.last_scalars[0] < 10
        assert sys_.last_route == "reset" and sys_.map is None
        assert sys_.state == tr.NOT_INITIALIZED
    else:
        sys_.state = tr.LOST
        _track(sys_, _frame(ref, 2), odom)
        assert sys_.n_lost_frames == 1
        assert sys_.last_route in ("relocalized", "reinitialized") and sys_.state == tr.OK


# ---------------------------------------------------------------------------
# sessions (io/session.py)
# ---------------------------------------------------------------------------

# the port's draws' generator states and the JAX package's keys
PORT_ONLY = {"draws_state", "lc_draws_state"}
JAX_ONLY = {"rng_key", "lc_rng_key"}


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_session_from_jax(ref, tmp_path):
    """The JAX facade's session after its three frames loads in the port:
    every map array, the last and the reference frame, the associations,
    the poses, the trajectory and every host field equal to the file's; the
    port saves it again under the same keys, shapes, dtypes and values (but
    for the draws' state, which each package keeps its own way)."""
    from fishbirdeyevisualslam_torch.io.session import load_session, save_session
    path = tmp_path / "jax_session.npz"
    path.write_bytes(ref["jax"]["session"])
    data = _npz(path)
    meta = json.loads(bytes(data["meta_json"]).decode())
    sys_ = load_session(str(path), SCFG, device="cpu")
    for prefix, tup in (("map_", sys_.map), ("lf_", sys_.last_frame), ("rf_", sys_.ref_frame)):
        for k, v in convert.to_numpy(tup).items():
            if k.endswith("desc_pm1"):   # rebuilt from the packed words
                src = data[prefix + k.replace("_pm1", "")]
                bits = (src[..., None] >> np.arange(32, dtype=np.uint32)) & 1
                want = bits.reshape(src.shape[:-1] + (256,)).astype(np.float32) * 2 - 1
            else:
                want = data[prefix + k]
            assert v.dtype == want.dtype and v.shape == want.shape, prefix + k
            np.testing.assert_array_equal(v, want, err_msg=prefix + k)
    np.testing.assert_array_equal(sys_.last_assoc.mp_idx.numpy(), data["assoc_mp"])
    np.testing.assert_array_equal(sys_.last_assoc.bp_idx.numpy(), data["assoc_bp"])
    np.testing.assert_array_equal(sys_.last_Tcw.numpy(), data["last_Tcw"])
    np.testing.assert_array_equal(sys_._velocity.numpy(), data["velocity"])
    traj = sys_.trajectory
    assert len(traj) == N_FRAMES == len(data["traj_ts"])
    np.testing.assert_array_equal(np.stack([e.T_rel for e in traj]), data["traj_T_rel"])
    for key, attr in (("traj_ts", "timestamp"), ("traj_ref_kf", "ref_kf"),
                      ("traj_is_kf", "is_keyframe"), ("traj_state", "state"),
                      ("traj_ref_fid", "ref_frame_id")):
        np.testing.assert_array_equal([getattr(e, attr) for e in traj], data[key], err_msg=key)
    host = dict(state=sys_.state, frame_id=sys_.frame_id, last_kf_slot=sys_.last_kf_slot,
                last_kf_frame_id=sys_.last_kf_frame_id, ref_kf_tracked=sys_.ref_kf_tracked,
                n_lost_frames=sys_.n_lost_frames, reloc_frame_id=sys_._reloc_frame_id,
                n_loops_closed=sys_.n_loops_closed,
                n_forced_kf_evictions=sys_.n_forced_kf_evictions,
                localization_only=sys_.localization_only, ref_frame_id=sys_.ref_frame_id,
                lc_last_loop_seq=sys_.loop_closer.last_loop_seq)
    assert host == {k: meta[k] for k in host}
    assert sys_.loop_closer.consistent_groups == [(frozenset(m), n) for m, n in meta["lc_groups"]]
    for key, d in (("odom_history", sys_._odom_history), ("kf_alive", sys_._kf_alive),
                   ("dead_kf", sys_._dead_kf_poses)):
        assert list(d) == meta[f"{key}_keys"]
        if d:
            np.testing.assert_array_equal(np.stack(list(d.values())), data[f"{key}_vals"])
    again = tmp_path / "port_session.npz"
    save_session(sys_, str(again))
    back = _npz(again)
    assert set(back) - PORT_ONLY == set(data) - JAX_ONLY
    for k in set(data) - JAX_ONLY - {"meta_json"}:
        assert back[k].dtype == data[k].dtype and back[k].shape == data[k].shape, k
        np.testing.assert_array_equal(back[k], data[k], err_msg=k)
    assert json.loads(bytes(back["meta_json"]).decode()) == meta


def test_session_resume_equals_uninterrupted(ref, tmp_path):
    """The port's facade saved after two of the three frames, loaded in a new
    facade and given the third, equals the uninterrupted run exactly: every
    map field, the trajectory and its export."""
    from fishbirdeyevisualslam_torch.io.session import load_session, save_session
    a = copy.deepcopy(ref["after_init"])
    a.draws = GumbelDraws(3)
    path = str(tmp_path / "session.npz")
    save_session(a, path)
    b = load_session(path, SCFG, device="cpu")
    assert b.frame_id == 1 and b.state == tr.OK and len(b.trajectory) == 2
    b.draws = JaxDraws(3)   # frame 2 draws nothing
    pose = _track(b, ref["frames"][2], ref["odom"][2])
    p = ref["port"]
    np.testing.assert_array_equal(pose, p["poses"][2])
    got = convert.map_state_to_numpy(b.map)
    for k, want in p["map"].items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    np.testing.assert_array_equal(np.stack([e.T_rel for e in b.trajectory]), p["T_rel"])
    np.testing.assert_array_equal(b.frame_trajectory_Twb(), p["Twb"])
    assert b.keyframe_trajectory_tum() == p["tum"]
    # the draws' generators are saved and restored too
    c = SlamSystem(SCFG, device="cpu")
    c.draws(1, 2, 3)
    save_session(c, path)
    d = load_session(path, SCFG, device="cpu")
    assert torch.equal(c.draws(1, 4, 5)[0], d.draws(1, 4, 5)[0])
    assert torch.equal(c.loop_closer.draws(1, 4, 5)[0], d.loop_closer.draws(1, 4, 5)[0])
