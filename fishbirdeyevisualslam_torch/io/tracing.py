"""Host-side tracing spans — the port of ``Tracer`` from
``fishbirdeyevisualslam_tpu/io/tracing.py``: named spans with accumulated
count, total and maximum (the per-stage analog of the reference's
``CalExTime``).  Each span also opens a ``torch.profiler.record_function``,
so that the spans line up with the device timeline of a profiler trace.
The times are host times: a span ends when its Python returns, not when the
card has finished the work it enqueued.  Spans may run in several threads
(the asynchronous mapping worker beside tracking): one lock guards the
accumulators.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch


class Tracer:
    """Named host spans with accumulated statistics.

    >>> tr = Tracer()
    >>> with tr.span("frame_build"):
    ...     pass
    >>> tr.report()["frame_build"]["count"]
    1
    """

    def __init__(self):
        self._acc: Dict[str, list] = {}  # name -> [count, total_s, max_s]
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
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

    def __getstate__(self):   # a lock does not copy or pickle; the counts do
        return {"_acc": {k: list(v) for k, v in self._acc.items()}}

    def __setstate__(self, d):
        self._acc = d["_acc"]
        self._lock = threading.Lock()
