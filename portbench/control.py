"""The control of the correctness check, on the card: the cell's set-up and
a short window on each seed, then the checks with the reference computed in
TF32 (the precision below the configuration's true f32) in the port's place.
Prints, per seed, the port's numbers and the control's; the limits in
``limits/<workload>.json`` lie between the two.  The benchmark's own runs
never run this.

    python3 portbench/control.py --workload dual-localize --seconds 8 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(workload: str, seeds, seconds: float, device) -> list:
    from portbench import run
    rows = []
    for seed in seeds:
        out = run.run_cell(workload, seed, seconds, False, device, control=True)
        rows.append(dict(seed=seed, correct=out["correct"], attempted=out["attempted"],
                         failed=out["failed"],
                         program={k: v["value"] for k, v in out["checks"].items()},
                         control=out["control"], frames=out["info"]["frames_checked"],
                         program_by_frame=out["info"]["core_by_frame"],
                         control_by_frame=out["info"]["control_core_by_frame"]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.seconds, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
