#!/usr/bin/env python3
"""Where ``ransac_pnp`` on the card and on the CPU part ways.

    python3 scripts/pnp_card_vs_cpu.py            # the card against the CPU (needs a card)
    python3 scripts/pnp_card_vs_cpu.py --cpu-only # the CPU in f32 against the CPU in f64

Runs ``solvers/pnp.py:ransac_pnp`` on the inputs of
``tests/test_torch_cuda.py::test_ransac_pnp_card`` (150 points, 30 outliers,
0.3 px noise; seed 9) and on four more seeds, on two routes with the same
Gumbel draws, recording every call of its building blocks (``_epnp_pose``,
the null-space SVD, the batched SPD solves, Horn's alignment, ``eigh``):

  * per seed: the minimal winner on each route (hypothesis index and inlier
    count), whether each all-inlier refit was kept, the pose at each stage
    (the largest se3 log component; card against CPU, and each against the
    f64 CPU run and the truth);
  * per seed, the second route run again with the first route's
    eigenvector signs (``eigh`` fixes each eigenvector up to its sign only,
    and LAPACK and cuSOLVER choose differently): the pose gap that is left;
  * for the test's seed: each recorded call of the two routes side by side
    (the largest difference of its inputs and of its outputs, relative to
    the largest magnitude), the null vectors compared up to sign with the
    singular values in f64, and EPnP's three beta initialisations'
    reprojection errors and which one won.

Needs no JAX.  The last line is one JSON object of the per-seed readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from fishbirdeyevisualslam_torch.config import SystemConfig  # noqa: E402
from fishbirdeyevisualslam_torch.geometry import camera, se3  # noqa: E402
from fishbirdeyevisualslam_torch.solvers import linalg, pnp  # noqa: E402
from fishbirdeyevisualslam_torch.solvers.initializer import GumbelDraws  # noqa: E402

SEEDS = (9, 10, 11, 12, 13)
N_POINTS, N_OUT, NOISE = 150, 30, 0.3
GATE = 5.991 * 4.0


def scene(seed: int, cam):
    """The card test's inputs at ``seed`` (seed 9 is the test's own)."""
    rng = np.random.RandomState(seed)
    n = N_POINTS
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n), rng.uniform(8, 30, n)],
                  -1).astype(np.float32)
    T = se3.exp(torch.tensor([0.05, 0.1, -0.05, 0.3, -0.2, 0.5]))
    uv = camera.project_pinhole(cam, se3.transform(T, torch.from_numpy(Xw))).numpy()
    uv = (uv + rng.randn(n, 2) * NOISE).astype(np.float32)
    uv[:N_OUT] = rng.uniform(0, 900, (N_OUT, 2))
    return Xw, uv, T, GumbelDraws(0)(1, 128, n)[0]


def pose_err(a, b) -> float:
    """The largest component of the se3 log of a b^-1 (the card tests' measure)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(se3.log(se3.compose(a, se3.inverse(b))).abs().max())


class Recorder:
    """Wraps pnp's building blocks for one run, recording (name, inputs,
    output) per call, and the stage of ``ransac_pnp`` each belongs to."""

    def __init__(self):
        self.calls, self.epnp = [], []

    def wrap(self, owner, name, label=None):
        fn = getattr(owner, name)

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((label or name, [a for a in args if torch.is_tensor(a)], out))
            return out
        return owner, name, fn, run

    def __enter__(self):
        orig_epnp = pnp._epnp_pose

        def epnp(cam, Xw, uv, w=None):
            n0 = len(self.calls)
            T = orig_epnp(cam, Xw, uv, w)
            self.epnp.append(dict(w=w, T=T, calls=(n0, len(self.calls))))
            return T
        self.patches = [self.wrap(linalg, "smallest_right_singular_vectors", "svd null vectors"),
                        self.wrap(linalg, "spd_solve"),
                        self.wrap(pnp, "horn_sim3"),
                        self.wrap(pnp, "_reproj_err"),
                        self.wrap(torch.linalg, "eigh"),
                        (pnp, "_epnp_pose", orig_epnp, epnp)]
        for owner, name, _, new in self.patches:
            setattr(owner, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, old, _ in self.patches:
            setattr(owner, name, old)


def signs_of(rec):
    """A ``torch.linalg.eigh`` whose i-th call returns its eigenvectors with
    the signs of the i-th ``eigh`` call recorded in ``rec`` (another run)."""
    ref = iter([o[1] for n, _, o in rec.calls if n == "eigh"])
    eigh0 = torch.linalg.eigh

    def eigh(A, *args, **kwargs):
        L, V = eigh0(A, *args, **kwargs)
        s = torch.sign(torch.sum(V * next(ref).to(V), dim=-2, keepdim=True))
        return L, V * torch.where(s == 0, 1.0, s)
    return eigh


def run(cam, Xw, uv, g, dev, dtype, eigh=None):
    t = lambda x: torch.as_tensor(x).to(dev, dtype)
    eigh0 = torch.linalg.eigh
    torch.linalg.eigh = eigh or eigh0
    try:
        with Recorder() as rec:
            out = pnp.ransac_pnp(cam, t(Xw), t(uv),
                                 torch.ones(len(Xw), dtype=torch.bool, device=dev),
                                 g.to(dev, dtype))
    finally:
        torch.linalg.eigh = eigh0
    return out, rec


def stages(cam, Xw, uv, rec):
    """The pose after the minimal stage and each refit, the minimal winner
    (index, inliers) and whether each refit was kept, from the recorded
    ``_epnp_pose`` outputs (ransac_pnp's own rule, recomputed)."""
    e0 = rec.epnp[0]["T"]
    X, u = torch.as_tensor(Xw).to(e0), torch.as_tensor(uv).to(e0)
    count = lambda T: (pnp._reproj_err(cam, T, X, u) < GATE)
    counts = count(e0[:, None, :]).sum(1)
    win = int(torch.argmax(counts))
    T, inl = e0[win], count(e0[win])
    out = dict(winner=win, winner_inliers=int(inl.sum()), poses=[T], kept=[])
    for r in rec.epnp[1:]:
        inl_r = count(r["T"])
        kept = bool(inl_r.sum() >= inl.sum())
        if kept:
            T, inl = r["T"], inl_r
        out["kept"].append(kept)
        out["poses"].append(T)
    return out


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    ok = torch.isfinite(a) & torch.isfinite(b)
    scale = float(torch.clamp(torch.max(torch.abs(torch.where(ok, b, 0.0))), min=1e-30))
    return float(torch.max(torch.abs(torch.where(ok, a - b, 0.0)))) / scale


def compare_calls(cam, Xw, uv, ra, rb, names) -> None:
    """Each recorded call of run ``a`` beside the same call of run ``b``."""
    for j, (ea, eb) in enumerate(zip(ra.epnp, rb.epnp)):
        stage = "minimal (128 hypotheses)" if j == 0 else f"refit {j}"
        print(f"-- EPnP call {j}, {stage}: pose {names[0]} vs {names[1]} "
              f"{pose_err(ea['T'].reshape(-1, 7)[0], eb['T'].reshape(-1, 7)[0]) if j else '-'}")
        for (na, ia, oa), (_, ib, ob) in zip(ra.calls[ea["calls"][0]:ea["calls"][1]],
                                             rb.calls[eb["calls"][0]:eb["calls"][1]]):
            if na == "_reproj_err":
                continue
            oa_t = oa if torch.is_tensor(oa) else torch.cat([x.reshape(-1) for x in oa])
            ob_t = ob if torch.is_tensor(ob) else torch.cat([x.reshape(-1) for x in ob])
            note = ""
            if na == "eigh":
                dots = torch.sum(oa[1].double().cpu() * ob[1].double().cpu(), dim=-2)
                note = f"; eigenvectors of opposite sign: {int((dots < 0).sum())} of " \
                       f"{dots.numel()}"
            if na == "svd null vectors":
                # up to sign, per vector; singular values of the input in f64
                sgn = torch.sign(torch.sum(oa.double().cpu() * ob.double().cpu(), -1,
                                           keepdim=True))
                oa_t = oa.double().cpu() * sgn
                ob_t = ob.double().cpu()
                if j:
                    sv = torch.linalg.svdvals(ia[0].double().cpu())
                    note = f"; singular values (f64) of the input, smallest 6: " \
                           f"{[float(f'{x:.4g}') for x in sv.flip(0)[:6]]}"
            ins = max((_rel(x, y) for x, y in zip(ia, ib)), default=0.0)
            print(f"   {na:24s} inputs differ by {ins:.3g}, outputs by "
                  f"{_rel(oa_t, ob_t):.3g} (relative to the largest magnitude){note}")
        if j:
            # EPnP's three initialisations after Gauss-Newton: the reprojection
            # error of each (the last _reproj_err call of this EPnP) and the winner
            ea_err = [o for n, _, o in ra.calls[ea["calls"][0]:ea["calls"][1]]
                      if n == "_reproj_err"][-1]
            eb_err = [o for n, _, o in rb.calls[eb["calls"][0]:eb["calls"][1]]
                      if n == "_reproj_err"][-1]
            for nm, e, rec in ((names[0], ea_err, ea), (names[1], eb_err, eb)):
                s = torch.sum(e * rec["w"][None, :], dim=-1).double().cpu()
                print(f"   {nm}: the three initialisations' weighted squared reprojection "
                      f"errors {[float(f'{x:.6g}') for x in s]}, chosen {int(torch.argmin(s))}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-only", action="store_true")
    args = p.parse_args()
    cam = SystemConfig().camera
    cpu = torch.device("cpu")
    if args.cpu_only:
        dev, names = cpu, ("cpu-f32", "cpu-f64")
    else:
        if not torch.cuda.is_available():
            print("no CUDA device", flush=True)
            return 1
        dev, names = torch.device("cuda"), ("card-f32", "cpu-f32")
    readings = []
    for seed in SEEDS:
        Xw, uv, T_true, g = scene(seed, cam)
        ra = run(cam, Xw, uv, g, dev, torch.float32)
        rb = run(cam, Xw, uv, g, cpu, torch.float64 if args.cpu_only else torch.float32)
        r64 = run(cam, Xw, uv, g, cpu, torch.float64)
        # the second route again with the first route's eigenvector signs
        rs = run(cam, Xw, uv, g, cpu, torch.float64 if args.cpu_only else torch.float32,
                 eigh=signs_of(ra[1]))
        sa, sb, s64 = (stages(cam, Xw, uv, r[1]) for r in (ra, rb, r64))
        row = dict(seed=seed, same_inliers=bool(torch.equal(ra[0].inliers.cpu(),
                                                            rb[0].inliers.cpu())),
                   n_inliers=[int(ra[0].n_inliers), int(rb[0].n_inliers)],
                   winner=[sa["winner"], sb["winner"], s64["winner"]],
                   winner_inliers=[sa["winner_inliers"], sb["winner_inliers"]],
                   kept=[sa["kept"], sb["kept"], s64["kept"]],
                   stage_err=[pose_err(a, b) for a, b in zip(sa["poses"], sb["poses"])],
                   final_err=pose_err(ra[0].Tcw, rb[0].Tcw),
                   final_err_same_signs=pose_err(ra[0].Tcw, rs[0].Tcw),
                   same_inliers_same_signs=bool(torch.equal(ra[0].inliers.cpu(),
                                                            rs[0].inliers.cpu())),
                   vs_f64=[pose_err(ra[0].Tcw, r64[0].Tcw), pose_err(rb[0].Tcw, r64[0].Tcw)],
                   vs_truth=[pose_err(ra[0].Tcw, T_true), pose_err(rb[0].Tcw, T_true),
                             pose_err(r64[0].Tcw, T_true)])
        readings.append(row)
        print(f"seed {seed} ({names[0]} / {names[1]} / cpu-f64): {row}", flush=True)
        if seed == SEEDS[0]:
            compare_calls(cam, Xw, uv, ra[1], rb[1], names)
    print(json.dumps(dict(routes=names, readings=readings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
