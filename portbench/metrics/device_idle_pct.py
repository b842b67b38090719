"""device_idle_pct (device): the share of the profiled slice in which no
kernel, copy or set ran on the card, in percent."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
