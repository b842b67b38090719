"""drift_pct (end to end): KITTI odometry's translational error on 5 m
segments of the window's trajectory (``evaluate.drift_pct``), in percent."""

from portbench import evaluate


def read(run):
    value, n = evaluate.drift_pct(run.est_Twb, run.gt)
    return value
