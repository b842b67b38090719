"""mapping_host_ms (local mapping): mean host ms per keyframe of the
benchmark's span around ``tracking.local_mapping_step`` in the window."""


def read(run):
    n, total = run.spans.get("mapping", (0, 0.0))
    return total / n * 1e3 if n else None
