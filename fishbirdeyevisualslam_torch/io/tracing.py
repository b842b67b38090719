"""Host-side tracing spans and device traces — the port of
``fishbirdeyevisualslam_tpu/io/tracing.py``.

  * ``Tracer``: named spans with accumulated count, total and maximum (the
    per-stage analog of the reference's ``CalExTime``).  Each span also opens
    a ``torch.profiler.record_function``, so that the spans line up with the
    device timeline of a profiler trace.  The times are host times: a span
    ends when its Python returns, not when the card has finished the work it
    enqueued.  Spans may run in several threads (the asynchronous mapping
    worker beside tracking): one lock guards the accumulators.
  * ``device_trace``: a context manager around ``torch.profiler`` that writes
    a Chrome trace (CPU activities, and the card's where there is one) under
    ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch


class Tracer:
    """Named host spans with accumulated statistics.

    >>> tr = Tracer()
    >>> with tr.span("frame_build"):
    ...     pass
    >>> tr.report()["frame_build"]["count"]
    1
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._acc: Dict[str, list] = {}  # name -> [count, total_s, max_s]
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            a = self._acc.setdefault(name, [0, 0.0, 0.0])
            a[0] += 1
            a[1] += dt
            a[2] = max(a[2], dt)

    def report(self) -> Dict[str, dict]:
        with self._lock:
            items = sorted((k, tuple(v)) for k, v in self._acc.items())
        return {k: {"count": c, "total_s": t, "mean_s": t / max(c, 1), "max_s": mx}
                for k, (c, t, mx) in items}

    def reset(self):
        with self._lock:
            self._acc.clear()

    def __getstate__(self):   # a lock does not copy or pickle; the counts do
        return {"enabled": self.enabled, "_acc": {k: list(v) for k, v in self._acc.items()}}

    def __setstate__(self, d):
        self.enabled = d.get("enabled", True)
        self._acc = d["_acc"]
        self._lock = threading.Lock()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Profile the enclosed code with ``torch.profiler`` and write its Chrome
    trace to ``trace_dir/trace_<pid>_<ns>.json`` (no-op if ``trace_dir`` is
    None or empty)."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
