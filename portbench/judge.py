"""How ``correct`` is decided: the port's outputs on the window frames drawn
from the seed, held to the plain reference (``reference/``) worked out again
from the benchmark's own inputs.

The check draws frames from the whole first ``check_span`` of the window
(``traffic.check_sample``) and captures each with the frame before it.  For
each checked frame:

* the frame build: the reference builds the frame, and the one before it,
  from the same uint8 images and odometry the port was handed;
  ``frame_mismatch`` is the share of keypoint rows (front and bird, valid on
  either side) whose validity, level, position (by more than 1e-3 px) or
  any descriptor bit differ;
* the tracking core: where the frame before was a plain tracked frame (the
  core's route, OK, no keyframe), the reference works out the facade's
  handoff itself from what the port returned for it: the map the core
  returned, the pose ``track`` returned, the odometry motion prior, the
  motion-model candidates, the last frame's bird view (its own build) and
  bird associations; elsewhere it takes the port's handoff as the core got
  it (the reference cannot rebuild the map the port's earlier frames made).
  Three numbers, each read per checked frame and compared by its fourth
  largest, so that at most three of the frames may pass its limit: on a
  sound run one inlier flipped at the chi2 gate by rounding changes the
  local map the frame matches against, and with it that frame's pose (by
  1-15 mm), associations and map writes; such a frame came once in 12 on a
  third of the seeds, never twice (``PERF.md``).  The numbers:
  ``core_pose_gap_mm``, the gap between the two poses' camera centres;
  ``assoc_mismatch``, the share of associated features (on either side)
  whose final map point differs; ``core_map_mismatch``, the share of the
  rows of the map that the core wrote on either side (found and visible
  counts, bird points created or culled: every field of ``MapState``, row by
  row, against the map it started from) that differ between the two
  (floats by more than 1e-3);
* the local mapping step, where the frame made a keyframe: the reference
  maps the port's map as inserted; ``map_kf_gap_mm`` is the widest gap
  between keyframe camera centres (the keyframes valid on both sides, the
  new keyframe's pose being what ``track`` returned), ``map_point_gap_mm`` the
  99th percentile of the gaps between landmark positions valid on both
  sides (front and bird points each; the larger of the two), and
  ``map_point_mismatch`` the share of landmark slots valid on one side only.

The limits are per cell, in ``limits/<workload>.json``; a number a cell's
limits name that no checked frame could read makes the run not correct.
The control (``tests/test_portbench_control.py``) puts the reference,
computed with TF32 matrix products, in the port's place.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load_limits(workload: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{workload}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no correctness limits for {workload!r} ({path})")
    return json.loads(path.read_text())["limits"]


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions in true f32 (the port's
    policy), or in TF32 (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _ref():
    from portbench.reference.geometry import odometry, se3
    from portbench.reference.slam import frame, map_state, tracking
    return frame, map_state, tracking, se3, odometry


def _centre(se3, T):
    return se3.inverse(T.to(torch.float32))[..., 4:7]


def _handoff(prev: dict, f_prev, f, ci: dict, rcfg, ms, tracking, odometry, device):
    """The tracking core's arguments for a frame, as the facade's handoff
    gives them after a plain tracked frame ``prev``, worked out from what the
    port returned for it: (map, Tcw_pred, cand_last, last_f, last_bp_idx,
    last_Tcw)."""
    c = prev["core_out"]
    m = ms.MapState(*c["map"])
    last_Tcw = torch.as_tensor(prev["returned"], dtype=torch.float32, device=device)
    Tcw_pred = odometry.motion_prior_Tcw(rcfg.extrinsics, last_Tcw, f_prev.odom, f.odom)
    cand_last = torch.cat([c["mp_idx"], m.kf_mp[ci["ref_kf"]]])
    return m, Tcw_pred, cand_last, tracking.bird_only_view(f_prev), c["bp_idx"], last_Tcw


def reference_outputs(caps: dict, drive, rcfg, device, tf32: bool = False) -> dict:
    """The reference's outputs for every captured frame: {frame: dict(frame=,
    core=(Tcw, mp_idx, bp_idx, map), core_base=the map the core started from,
    map=MapState)}."""
    frame, ms, tracking, _, odometry = _ref()
    out = {}
    with precision(tf32), torch.no_grad():
        for k, cap in sorted(caps.items()):
            img, _, odom, ts = cap["input"]
            out[k] = dict(frame=frame.build_frame(
                torch.as_tensor(drive.front[img], dtype=torch.float32, device=device),
                torch.as_tensor(drive.bird[img], dtype=torch.float32, device=device),
                torch.as_tensor(drive.mask, dtype=torch.float32, device=device),
                torch.as_tensor(odom, device=device), float(ts), rcfg,
                rcfg.capacity.max_front_kp, None, rcfg.capacity.max_bird_kp, device=device))
        for k, cap in sorted(caps.items()):
            o, f = out[k], out[k]["frame"]
            ci = cap.get("core_in")
            if ci is not None and cap.get("checked"):
                prev = caps.get(k - 1, {})
                if prev.get("plain") and rcfg.flags.loose_couple:
                    m, Tcw_pred, cand_last, last_f, last_bp_idx, last_Tcw = _handoff(
                        prev, out[k - 1]["frame"], f, ci, rcfg, ms, tracking, odometry, device)
                else:
                    m, Tcw_pred, cand_last = ms.MapState(*ci["m"]), ci["Tcw_pred"], ci["cand_last"]
                    last_f = None if ci["last_f"] is None else frame.Frame(*ci["last_f"])
                    last_bp_idx, last_Tcw = ci["last_bp_idx"], ci["last_Tcw"]
                r = tracking._track_frame_core(
                    m, f, rcfg, Tcw_pred, cand_last, ci["ref_kf"], last_f, last_bp_idx,
                    last_Tcw, ci["bird_maint_enabled"])
                o["core"] = (r.Tcw, r.mp_idx, r.bp_idx, r.map)
                o["core_base"] = m
            mi = cap.get("map_in")
            if mi is not None:
                o["map"] = tracking.local_mapping_step(ms.MapState(*mi["m"]), mi["slot"],
                                                       rcfg, mi["n_nb"], device=device)
                o["returned"] = o["map"].kf_Tcw[mi["slot"]]
    return out


def program_outputs(caps: dict) -> dict:
    """The port's outputs, in ``reference_outputs``' layout."""
    out = {}
    for k, cap in caps.items():
        o = dict(frame=cap["frame"])
        if "core_out" in cap and cap.get("checked"):
            c = cap["core_out"]
            o["core"] = (c["Tcw"], c["mp_idx"], c["bp_idx"], c["map"])
        if "map_out" in cap:
            o["map"] = cap["map_out"]
            o["returned"] = torch.as_tensor(cap["returned"], device=cap["map_out"].kf_Tcw.device)
        out[k] = o
    return out


def _rows_mismatch(a_uv, a_oct, a_desc, a_valid, b_uv, b_oct, b_desc, b_valid):
    either = a_valid | b_valid
    bad = ((a_valid != b_valid) | (a_oct != b_oct)
           | (torch.abs(a_uv - b_uv).amax(-1) > 1e-3) | torch.any(a_desc != b_desc, dim=-1))
    return int((bad & either).sum()), int(either.sum())


def _row_differs(a, b):
    """Per row (the first axis; a 0-d counter is one row): any element differs,
    floats by more than 1e-3."""
    a, b = (x.reshape(1, -1) if x.dim() == 0 else x.reshape(x.shape[0], -1) for x in (a, b))
    if a.is_floating_point():
        d = ~torch.isclose(a.float(), b.float(), rtol=0.0, atol=1e-3, equal_nan=True)
    else:
        d = a != b
    return d.any(dim=1)


def _map_rows(a, b, base) -> tuple:
    """(rows where maps ``a`` and ``b`` differ, rows that either wrote against
    ``base``), over every field."""
    bad = written = 0
    for x, y, z in zip(a, b, base):
        y, z = y.to(x.device), z.to(x.device)
        bad += int(_row_differs(x, y).sum())
        written += int((_row_differs(x, z) | _row_differs(y, z)).sum())
    return bad, written


FRAMES_ALLOWED = 3   # checked frames that may pass a core number's limit


def _after_allowed(values: list) -> float:
    """The largest of ``values`` once the ``FRAMES_ALLOWED`` largest are set
    aside (the smallest, where there are no more)."""
    v = sorted(values)
    return v[-min(FRAMES_ALLOWED + 1, len(v))]


def compare(prog: dict, ref: dict, per_frame: dict | None = None) -> dict:
    """The numbers compared, over every frame both sides have.  Where given,
    ``per_frame`` gets each checked frame's core numbers."""
    _, _, _, se3, _ = _ref()
    rows = [0, 0]
    core = {}      # frame -> (pose gap mm, assoc share, map share)
    kf_gap = pt_gap = None
    pt_n = [0, 0]
    for k in sorted(set(prog) & set(ref)):
        p, r = prog[k], ref[k]
        pf, rf = p["frame"], r["frame"]
        for view in ("", "bird_"):
            uv = "uv_raw" if view == "" else "bird_uv"
            b, n = _rows_mismatch(
                getattr(pf, uv), getattr(pf, view + "octave"), getattr(pf, view + "desc"),
                getattr(pf, view + "kp_valid"), getattr(rf, uv).to(pf.uv.device),
                getattr(rf, view + "octave").to(pf.uv.device),
                getattr(rf, view + "desc").to(pf.uv.device),
                getattr(rf, view + "kp_valid").to(pf.uv.device))
            rows[0] += b
            rows[1] += n
        if "core" in p and "core" in r:
            (pT, pm, pb, pmap), (rT, rm, rb, rmap) = p["core"], r["core"]
            gap = float(torch.linalg.norm(_centre(se3, pT) - _centre(se3, rT.to(pT.device)))) * 1e3
            assoc = [0, 0]
            for a, b in ((pm, rm.to(pm.device)), (pb, rb.to(pb.device))):
                either = (a >= 0) | (b >= 0)
                assoc[0] += int(((a != b) & either).sum())
                assoc[1] += int(either.sum())
            b, n = _map_rows(pmap, rmap, r["core_base"])
            core[k] = (gap, assoc[0] / max(assoc[1], 1), b / max(n, 1))
        if "map" in p and "map" in r:
            pm, rm = p["map"], r["map"]
            both = pm.kf_valid & rm.kf_valid.to(pm.kf_valid.device)
            d = torch.linalg.norm(_centre(se3, pm.kf_Tcw) - _centre(se3, rm.kf_Tcw.to(
                pm.kf_Tcw.device)), dim=-1)
            g = float(torch.where(both, d, 0.0).max()) * 1e3
            g = max(g, float(torch.linalg.norm(_centre(se3, p["returned"])
                                               - _centre(se3, r["returned"].to(
                                                   p["returned"].device)))) * 1e3)
            kf_gap = g if kf_gap is None else max(kf_gap, g)
            for pos, valid in (("mp_pos", "mp_valid"), ("bp_pos", "bp_valid")):
                a_v, b_v = getattr(pm, valid), getattr(rm, valid).to(pm.kf_valid.device)
                both = a_v & b_v
                d = torch.linalg.norm(getattr(pm, pos) - getattr(rm, pos).to(a_v.device), dim=-1)
                g = float(torch.quantile(d[both].double(), 0.99)) * 1e3 if bool(both.any()) else 0.0
                pt_gap = g if pt_gap is None else max(pt_gap, g)
                pt_n[0] += int((a_v != b_v).sum())
                pt_n[1] += int((a_v | b_v).sum())
    out = {}
    if rows[1]:
        out["frame_mismatch"] = rows[0] / rows[1]
    if core:
        for i, name in enumerate(("core_pose_gap_mm", "assoc_mismatch", "core_map_mismatch")):
            out[name] = _after_allowed([c[i] for c in core.values()])
    if per_frame is not None:
        per_frame.update(core)
    if kf_gap is not None:
        out["map_kf_gap_mm"] = kf_gap
        out["map_point_gap_mm"] = pt_gap
        out["map_point_mismatch"] = pt_n[0] / max(pt_n[1], 1)
    return out


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, number or None, limit)]): every number the limits
    name is read and at most its limit."""
    rows = [(name, numbers.get(name), lim) for name, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
