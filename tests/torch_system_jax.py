"""The JAX package's ``SlamSystem`` over the first frames of a drive, on the
port's Frames: the reference of ``tests/test_torch_system.py``.

    python tests/torch_system_jax.py DIR N_FRAMES

Reads the configuration from ``DIR/config.pkl`` (``dataclasses.asdict`` of a
``SystemConfig``) and the Frames from ``DIR/frame_<k>.pkl``, the k-th Frame
that the port's facade built over the same drive (``index``, the frame's
number; ``n_front``, its front budget; ``frame``, the Frame as numpy arrays),
waiting for each file to appear: the test starts this process first and
writes the files as the port builds them.  The JAX facade's ``build_frame``
is replaced by a reader of those files, which fails unless the JAX facade
asks for the same frame at the same budget, so the two facades start every
frame from the same Frame (the extraction's parity is
``tests/test_torch_extract.py``'s).  Loop closing is off.  Writes to
``DIR/jax.pkl`` the pose of each frame, the states, the keyframe indices, the
per-frame trajectory, the TUM export, the map's counts after each frame and
the (frame, budget) of each Frame it asked for, and to ``DIR/session.npz``
the facade's session after its frames (``io/session.py:save_session``).

The test runs this script in a process of its own because the facade's
jitted functions take no compiler options: it sets ``XLA_FLAGS`` (backend
optimisation level 0, no fusion emitters) for about a third of the compile
CPU of XLA's defaults.
"""

import os
import pickle
import sys
import threading
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fishbirdeyevisualslam_tpu import config as jcfg  # noqa: E402
from fishbirdeyevisualslam_tpu.io.session import save_session  # noqa: E402
from fishbirdeyevisualslam_tpu.slam import map_state as jms  # noqa: E402
from fishbirdeyevisualslam_tpu.slam import system as jsystem  # noqa: E402
from fishbirdeyevisualslam_tpu.slam import tracking as jtr  # noqa: E402
from fishbirdeyevisualslam_tpu.slam.frame import Frame  # noqa: E402

FRONT_FIELDS = ("uv_raw", "uv", "octave", "angle", "desc", "desc_pm1", "kp_valid")


def config(mod, d: dict):
    """``mod.SystemConfig`` from ``dataclasses.asdict`` of one."""
    base = mod.SystemConfig()
    return mod.SystemConfig(**{
        name: type(getattr(base, name))(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in sub.items()})
        for name, sub in d.items()})


def wait_load(path: str, deadline: float):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.02)
    with open(path, "rb") as f:
        return pickle.load(f)


def _frame(d: dict) -> Frame:
    return Frame(**{k: jnp.asarray(v, jnp.bfloat16 if k.endswith("desc_pm1") else None)
                    for k, v in d.items()})


def compile_tracked_frame(cfg, f: Frame) -> None:
    """Compiles the programs of a tracked keyframe frame, with the argument
    types of the facade's calls in ``_track_ok`` (on an empty map), so that
    their compile overlaps the facade's initialization: ``track_frame_core``,
    ``insert_keyframe`` and ``local_mapping_step``."""
    c = cfg.capacity
    m = jms.empty_map(cfg)
    Tcw = jnp.asarray(np.array([1, 0, 0, 0, 0, 0, 0], np.float32))
    core = jtr.track_frame_core(
        m, f, cfg, Tcw, jnp.full((2 * c.max_front_kp,), -1, jnp.int32), jnp.int32(0),
        last_f=jtr.bird_only_view(f), last_bp_idx=jnp.full((c.max_bird_kp,), -1, jnp.int32),
        last_Tcw=Tcw, bird_maint_enabled=jnp.asarray(True))
    slot, _, _ = jtr.free_kf_slot(m)
    m = jtr.insert_keyframe(m, f, jtr.TrackObs(core.mp_idx, core.bp_idx), core.Tcw, cfg,
                            jnp.int32(0), slot=slot)
    jax.block_until_ready(jtr.local_mapping_step(m, jnp.int32(0), cfg,
                                                 cfg.tracking.mapping_neighbors))


def main(root: str, n_frames: int, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    cfg = config(jcfg, wait_load(os.path.join(root, "config.pkl"), deadline))
    F = cfg.capacity.max_front_kp
    served, current = [], [0]

    def next_frame() -> dict:
        got = wait_load(os.path.join(root, f"frame_{len(served)}.pkl"), deadline)
        served.append(got)
        return got

    # the first Frame cut to the tracking budget: the compile thread's input
    # (only its shapes and types matter)
    first = next_frame()["frame"]
    warm = threading.Thread(target=compile_tracked_frame, args=(cfg, _frame(
        {k: v[:F] if k in FRONT_FIELDS else v for k, v in first.items()})))
    warm.start()
    requests, pos = [], [0]

    def port_build_frame(front, bird, mask, odom, timestamp, cfg_, n_front, contour, n_bird):
        requests.append((current[0], int(n_front)))
        got = served[pos[0]] if pos[0] < len(served) else next_frame()
        pos[0] += 1
        if (got["index"], got["n_front"]) != requests[-1]:
            raise RuntimeError(f"the JAX facade asked for {requests[-1]}, the port built "
                               f"{(got['index'], got['n_front'])}")
        return _frame(got["frame"])

    jsystem.build_frame = port_build_frame
    sys_ = jsystem.SlamSystem(cfg)
    sys_.enable_loop_closing = False
    poses, counts = [], []
    # the facade's inputs reach nothing but build_frame: the Frames come from the port
    pixel, odom = np.zeros((1, 1), np.float32), np.zeros(3, np.float32)
    for i in range(n_frames):
        current[0] = i
        if sys_.state != jsystem.tr.NOT_INITIALIZED:
            warm.join()
        poses.append(sys_.track(pixel, pixel, pixel, odom, 0.0))
        m = sys_.map
        counts.append(None if m is None else {
            "kf_valid": int(np.asarray(m.kf_valid).sum()), "n_kf": int(m.n_kf),
            "mp_valid": int(np.asarray(m.mp_valid).sum()),
            "bp_valid": int(np.asarray(m.bp_valid).sum())})
    warm.join()
    save_session(sys_, os.path.join(root, "session.npz"))
    out = os.path.join(root, "jax.pkl")
    with open(out + ".tmp", "wb") as fh:
        pickle.dump(dict(
            poses=np.stack(poses), states=[e.state for e in sys_.trajectory],
            kf_indices=sys_.keyframe_indices(), Twb=sys_.frame_trajectory_Twb(),
            tum=sys_.keyframe_trajectory_tum(), counts=counts, requests=requests), fh)
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
