"""frame_build_host_ms (frame build): mean host ms per window frame of the
port's own Tracer span ``frame_build`` (upload and ``build_frame``)."""


def read(run):
    n, total = run.tracer.get("frame_build", (0, 0.0))
    return total / n * 1e3 if n else None
