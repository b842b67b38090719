"""core_host_ms (tracking core): mean host ms per call of the benchmark's
span around ``tracking.track_frame_core`` in the window."""


def read(run):
    n, total = run.spans.get("core", (0, 0.0))
    return total / n * 1e3 if n else None
