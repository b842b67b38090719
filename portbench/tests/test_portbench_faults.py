"""The correctness check sees a broken timed path: a run of the harness on
the CPU (its look for a card skipped: ``run.run_cell`` with a CPU device,
the tiny cells of ``tiny.py``), sound and with one fault planted underneath
the benchmark's probes each time; ``correct`` must come out true for the
sound run and false for every fault.  The cells run on one card, so there is
no exchange between chips to leave out.  About half a minute a run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests import tiny

SEED = 2**31 + 77
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def cell(mix):
    return f"tiny-dual.{mix}"


def core_unchanged(monkeypatch):
    """The tracking core returns its state unchanged: the predicted pose and
    the map it was handed."""
    from fishbirdeyevisualslam_torch.slam import tracking
    orig = tracking._track_frame_core

    def broken(m, f, cfg, Tcw_pred, *a, **kw):
        out = orig(m, f, cfg, Tcw_pred, *a, **kw)
        return out._replace(Tcw=Tcw_pred.clone(), map=m)
    monkeypatch.setattr(tracking, "_track_frame_core", broken)


def core_map_unchanged(monkeypatch):
    """The tracking core returns the map it was handed, with its pose and
    associations kept: no found or visible counts, no bird point made or
    culled."""
    from fishbirdeyevisualslam_torch.slam import tracking
    orig = tracking._track_frame_core

    def broken(m, *a, **kw):
        return orig(m, *a, **kw)._replace(map=m)
    monkeypatch.setattr(tracking, "_track_frame_core", broken)


def stale_prior(monkeypatch):
    """The facade hands the core the last pose as its prior, the odometry
    since the last frame left out."""
    from fishbirdeyevisualslam_torch.slam import system
    monkeypatch.setattr(system.SlamSystem, "_motion_prior", lambda self, f: self.last_Tcw)


def half_the_keypoints(monkeypatch):
    """Half of the front keypoints left out of the frame build."""
    from fishbirdeyevisualslam_torch.ops import features
    orig = features.extract_dual

    def broken(*a, **kw):
        kp, bkp = orig(*a, **kw)
        n = kp.valid.shape[0]
        return kp._replace(valid=kp.valid & (torch.arange(n) < n // 2)), bkp
    monkeypatch.setattr(features, "extract_dual", broken)


def descriptor_bit(monkeypatch):
    """One bit of one descriptor flipped where the frame build produces it."""
    from fishbirdeyevisualslam_torch.ops import features
    orig = features.extract_dual

    def broken(*a, **kw):
        kp, bkp = orig(*a, **kw)
        desc = kp.desc.clone()
        desc[0, 0] ^= 1
        return kp._replace(desc=desc), bkp
    monkeypatch.setattr(features, "extract_dual", broken)


def pose_nudged(monkeypatch):
    """The pose optimisation's answer moved by 2 mm where it is produced."""
    from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
    orig = cuda_pose_opt.pose_optimization

    def broken(*a, **kw):
        out = orig(*a, **kw)
        return out._replace(Tcw=out.Tcw + torch.tensor([0, 0, 0, 0, 2e-3, 0, 0]))
    monkeypatch.setattr(cuda_pose_opt, "pose_optimization", broken)


def mapping_unchanged(monkeypatch):
    """The local mapping step returns its state unchanged."""
    from fishbirdeyevisualslam_torch.slam import tracking
    monkeypatch.setattr(tracking, "local_mapping_pre", lambda m, *a, **kw: m)
    monkeypatch.setattr(tracking, "local_mapping_ba", lambda m, *a, **kw: m)


@pytest.mark.parametrize("mix", ["tiny-localize", "tiny-cruise"])
def test_sound_run_is_correct(root, mix):
    out = run.run_cell(cell(mix), SEED, 3.0, False, CPU, root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) >= {"fps", "setup_s"}
    assert list(out)[-1] == "checks"
    assert run.forbidden_modules() == []


def _reference_functions() -> set:
    """Every top-level function of the reference, as file:name."""
    import ast
    ref = Path(run.__file__).resolve().parent / "reference"
    out = set()
    for f in ref.rglob("*.py"):
        for n in ast.parse(f.read_text()).body:
            if isinstance(n, ast.FunctionDef):
                out.add(f"{f.relative_to(ref)}:{n.name}")
    return out


# reached by a cell that hands the frame build a contour image (none yet)
NOT_REACHED = {"slam/frame.py:bird_detection_mask"}


def test_reference_is_what_the_check_runs(root, monkeypatch):
    """The reference holds what the check runs, the frame build, the
    tracking core and the local mapping step, and nothing else: each of its
    functions is called by the check of the sound runs of both mixes."""
    from portbench import judge
    reached = set()
    ref = str(Path(run.__file__).resolve().parent / "reference") + "/"

    def prof(frame, event, arg):
        fn = frame.f_code.co_filename
        if event == "call" and fn.startswith(ref):
            reached.add(f"{fn[len(ref):]}:{frame.f_code.co_name}")
    orig = judge.reference_outputs

    def traced(*a, **kw):
        sys.setprofile(prof)
        try:
            return orig(*a, **kw)
        finally:
            sys.setprofile(None)
    monkeypatch.setattr(judge, "reference_outputs", traced)
    for name, mod in list(sys.modules.items()):   # cached tables are built again
        if name.startswith("portbench.reference"):
            for f in vars(mod).values():
                getattr(f, "cache_clear", lambda: None)()
    for mix in ("tiny-localize", "tiny-cruise"):
        assert run.run_cell(cell(mix), SEED, 3.0, False, CPU, root=root)["correct"]
    assert sorted(_reference_functions() - reached) == sorted(NOT_REACHED)


@pytest.mark.parametrize("mix, fault", [
    ("tiny-localize", core_unchanged),
    ("tiny-localize", core_map_unchanged),
    ("tiny-localize", stale_prior),
    ("tiny-localize", half_the_keypoints),
    ("tiny-localize", descriptor_bit),
    ("tiny-localize", pose_nudged),
    ("tiny-cruise", mapping_unchanged),
])
def test_fault_is_not_correct(root, monkeypatch, mix, fault):
    out = run.run_cell(cell(mix), SEED, 3.0, False, CPU, root=root,
                       on_window=lambda: fault(monkeypatch))
    assert not out["correct"], out["checks"]
