"""Whole-system checkpoint and resume — the port of
``fishbirdeyevisualslam_tpu/io/session.py``.  The reference has no way to
resume a run (``include/System.h:132-134``); ``io.checkpoint`` round-trips the
map, and this module the rest of a ``SlamSystem``'s host state: trajectory
entries, velocity, relocalization window, loop-consistency groups, the last
and the reference frame, the last associations, so that a restarted process
continues the run.

The file is the JAX package's layout: one compressed npz, the map under
``map_*``, the frames under ``lf_*`` and ``rf_*`` (derived +/-1 descriptors
left out), plain arrays under their own keys and the irregular host
structures as a JSON string ``meta_json``; no pickle.  A session saved by
the JAX package loads here field for field.  The random draws differ
between the packages: the port saves the state of its draws' generators
(``GumbelDraws``) as ``draws_state`` / ``lc_draws_state`` where the JAX
package saves its keys ``rng_key`` / ``lc_rng_key``; a JAX session's keys are
not used here (the draws start from their seeds).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from fishbirdeyevisualslam_torch.convert import array_to_tensor, tensor_to_array
from fishbirdeyevisualslam_torch.device import resolve_device
from fishbirdeyevisualslam_torch.io.checkpoint import map_arrays, map_from_arrays
from fishbirdeyevisualslam_torch.slam.frame import Frame, desc_pm1_from_packed

_FRAME_DERIVED = {"desc_pm1": "desc", "bird_desc_pm1": "bird_desc"}


def _frame_arrays(f: Frame, prefix: str) -> dict:
    return {prefix + k: tensor_to_array(k, v) for k, v in f._asdict().items()
            if k not in _FRAME_DERIVED}


def _frame_from(data, prefix: str, dev) -> Frame:
    ff = {}
    for k in Frame._fields:
        if k in _FRAME_DERIVED:
            src = _FRAME_DERIVED[k]
            ff[k] = desc_pm1_from_packed(array_to_tensor(src, data[prefix + src], dev))
        else:
            ff[k] = array_to_tensor(k, data[prefix + k], dev)
    return Frame(**ff)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_session(sys_, path: str) -> None:
    """Serialize a ``SlamSystem`` to ``path`` (npz).  Asynchronous mapping must
    be drained first (``finish()``): a job in flight lives in its process and
    cannot be saved.  The facade's and its loop closer's draws must be
    ``GumbelDraws``: their generators' states are saved."""
    if sys_._job_in_flight():
        raise RuntimeError("drain async mapping (finish()) before save_session")
    lc = sys_.loop_closer
    meta = {
        "state": int(sys_.state),
        "frame_id": int(sys_.frame_id),
        "last_kf_slot": int(sys_.last_kf_slot),
        "last_kf_frame_id": int(sys_.last_kf_frame_id),
        "ref_kf_tracked": int(sys_.ref_kf_tracked),
        "n_lost_frames": int(sys_.n_lost_frames),
        "reloc_frame_id": int(sys_._reloc_frame_id),
        "n_loops_closed": int(sys_.n_loops_closed),
        "n_forced_kf_evictions": int(sys_.n_forced_kf_evictions),
        "localization_only": bool(sys_.localization_only),
        "has_map": sys_.map is not None,
        "has_last_frame": sys_.last_frame is not None,
        "has_ref_frame": sys_.ref_frame is not None,
        "ref_frame_id": int(sys_.ref_frame_id),
        "has_last_assoc": sys_.last_assoc is not None,
        "has_reset_anchor": sys_._reset_anchor is not None,
        "lc_last_loop_seq": int(lc.last_loop_seq),
        "lc_groups": [[sorted(int(x) for x in members), int(streak)]
                      for members, streak in lc.consistent_groups],
        "odom_history_keys": [int(k) for k in sys_._odom_history],
        "kf_alive_keys": [int(k) for k in sys_._kf_alive],
        "dead_kf_keys": [int(k) for k in sys_._dead_kf_poses],
    }
    arrs = {}
    if sys_.map is not None:
        arrs.update(map_arrays(sys_.map, "map_"))
    if sys_.last_frame is not None:
        arrs.update(_frame_arrays(sys_.last_frame, "lf_"))
    if sys_.ref_frame is not None:
        arrs.update(_frame_arrays(sys_.ref_frame, "rf_"))
    if sys_.last_assoc is not None:
        arrs["assoc_mp"] = _host(sys_.last_assoc.mp_idx)
        arrs["assoc_bp"] = _host(sys_.last_assoc.bp_idx)
    arrs["last_Tcw"] = _host(sys_.last_Tcw)
    arrs["velocity"] = _host(sys_._velocity)
    for key, draws in (("", sys_.draws), ("lc_", lc.draws)):
        arrs[f"{key}draws_state"] = draws.generator.get_state().numpy()
    if sys_._reset_anchor is not None:
        arrs["reset_anchor_T"] = np.asarray(sys_._reset_anchor[0])
        arrs["reset_anchor_odom"] = np.asarray(sys_._reset_anchor[1])
    traj = sys_.trajectory
    arrs["traj_T_rel"] = np.stack([e.T_rel for e in traj]) if traj else np.zeros((0, 7),
                                                                                 np.float32)
    arrs["traj_ts"] = np.asarray([e.timestamp for e in traj])
    arrs["traj_ref_kf"] = np.asarray([e.ref_kf for e in traj], np.int32)
    arrs["traj_is_kf"] = np.asarray([e.is_keyframe for e in traj], bool)
    arrs["traj_state"] = np.asarray([e.state for e in traj], np.int32)
    arrs["traj_ref_fid"] = np.asarray([e.ref_frame_id for e in traj], np.int32)
    for key, d in (("odom_history_vals", sys_._odom_history), ("kf_alive_vals", sys_._kf_alive),
                   ("dead_kf_vals", sys_._dead_kf_poses)):
        if d:
            arrs[key] = np.stack([np.asarray(v) for v in d.values()])
    arrs["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrs)


def load_session(path: str, cfg=None, async_mapping: bool = False, device=None):
    """A ``SlamSystem`` on ``device`` (the current card by default) resumed
    from a ``save_session`` file of either package."""
    from fishbirdeyevisualslam_torch.config import SystemConfig
    from fishbirdeyevisualslam_torch.slam import tracking as tr
    from fishbirdeyevisualslam_torch.slam.system import SlamSystem, TrajectoryEntry

    dev = resolve_device(device)
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
    sys_ = SlamSystem(cfg or SystemConfig(), localization_only=meta["localization_only"],
                      async_mapping=async_mapping, device=dev)
    if meta["has_map"]:
        sys_.map = map_from_arrays(data, dev, "map_")
    if meta["has_last_frame"]:
        sys_.last_frame = _frame_from(data, "lf_", dev)
    if meta.get("has_ref_frame"):
        sys_.ref_frame = _frame_from(data, "rf_", dev)
    sys_.ref_frame_id = meta.get("ref_frame_id", -1)
    if meta["has_last_assoc"]:
        sys_.last_assoc = tr.TrackObs(array_to_tensor("assoc_mp", data["assoc_mp"], dev),
                                      array_to_tensor("assoc_bp", data["assoc_bp"], dev))
    sys_.state = meta["state"]
    sys_.frame_id = meta["frame_id"]
    sys_.last_kf_slot = meta["last_kf_slot"]
    sys_.last_kf_frame_id = meta["last_kf_frame_id"]
    sys_.ref_kf_tracked = meta["ref_kf_tracked"]
    sys_.n_lost_frames = meta["n_lost_frames"]
    sys_._reloc_frame_id = meta["reloc_frame_id"]
    sys_.n_loops_closed = meta["n_loops_closed"]
    sys_.n_forced_kf_evictions = meta["n_forced_kf_evictions"]
    sys_.last_Tcw = array_to_tensor("last_Tcw", data["last_Tcw"], dev)
    sys_._velocity = array_to_tensor("velocity", data["velocity"], dev)
    sys_._Tcw_host = np.asarray(data["last_Tcw"], np.float32)
    for key, draws in (("", sys_.draws), ("lc_", sys_.loop_closer.draws)):
        if f"{key}draws_state" in data:
            draws.generator.set_state(torch.from_numpy(data[f"{key}draws_state"].copy()))
    lc = sys_.loop_closer
    lc.last_loop_seq = meta["lc_last_loop_seq"]
    lc.consistent_groups = [(frozenset(members), streak) for members, streak in meta["lc_groups"]]
    if meta["has_reset_anchor"]:
        sys_._reset_anchor = (np.asarray(data["reset_anchor_T"]),
                              np.asarray(data["reset_anchor_odom"]))
    sys_.trajectory = [
        TrajectoryEntry(float(data["traj_ts"][i]), np.asarray(data["traj_T_rel"][i]),
                        int(data["traj_ref_kf"][i]), bool(data["traj_is_kf"][i]),
                        int(data["traj_state"][i]), int(data["traj_ref_fid"][i]))
        for i in range(len(data["traj_ts"]))]
    for attr, keys, vals in (("_odom_history", "odom_history_keys", "odom_history_vals"),
                             ("_kf_alive", "kf_alive_keys", "kf_alive_vals"),
                             ("_dead_kf_poses", "dead_kf_keys", "dead_kf_vals")):
        setattr(sys_, attr, {int(k): np.asarray(data[vals][i])
                             for i, k in enumerate(meta[keys])})
    return sys_
