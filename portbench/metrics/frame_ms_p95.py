"""frame_ms_p95 (facade): the 95th percentile of the window frames' latency,
the call into ``SlamSystem.track`` to its return with the pose on the host,
over the frames outside the profiled slice."""

import statistics


def read(run):
    ms = [t * 1e3 for t, traced in zip(run.latencies_s, run.traced) if not traced]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
