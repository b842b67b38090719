"""The control of the correctness check, on the card (``-m cuda``; skips
without one): each cell at its own size on three seeds, with a short
window; the port's numbers pass their limits and the control's (the
reference computed with TF32 products, the precision below the
configuration's true f32, in the port's place) fail one of them.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import pytest
import torch

SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dual-localize", "front-localize"])
def test_control_fails_where_the_port_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control, judge
    limits = judge.load_limits(workload)
    # a short window: the run tracks on past its close to every frame the check draws
    for row in control.readings(workload, SEEDS, 10.0, torch.device("cuda", 0)):
        assert row["correct"], row
        ok, _ = judge.decide(row["control"], limits)
        assert not ok, row
