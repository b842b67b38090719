"""kernels_roofline (kernels): the sum of the least times of the port's own
kernel launches in the profiled slice (``counts.py`` at the shapes the
launch records saw) over their device time in the trace, in percent."""


def read(run):
    p = run.profile
    if p is None or not p["own_s"] or not run.least_s:
        return None
    return 100.0 * run.least_s / p["own_s"]
