"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a fixed
slice of the window (one profiler per process), reduced in memory to the
numbers the per-layer readers take.  No trace file is written.

* ``busy_s``: the union of the card's activity intervals (kernels, copies,
  sets), merged; ``window_s``: the slice's wall time, between two
  synchronisations of the card.
* ``own_s``: the device time of the port's own kernels, by the
  ``__global__`` names of its CUDA sources.
* ``device_ops``: device time by operation name; ``idle_by_span``: the card's
  idle time by the innermost host span open when each gap began (the
  program's Tracer spans and the benchmark's ``bench.*`` spans; ``no span``
  where none was open).
"""

from __future__ import annotations

import bisect
import re
import time
from pathlib import Path

import torch

HOST_SPANS = ("frame_build", "initialize", "track", "track_lost", "loop_detect",
              "bench.core", "bench.mapping")


def own_kernel_names(csrc: Path) -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src.read_text()))
    return names


def base_name(name: str) -> str:
    """A device activity's function name without namespace, template
    arguments or parameters: ``(anonymous namespace)::pose_opt_kernel(...)``
    -> ``pose_opt_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = name.split("(", 1)[0].split("<", 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    if f is not None and f():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind())


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self, own_names: set) -> dict:
        """The slice's numbers (see the module's docstring)."""
        dev_iv, host = [], []
        by_name = {}
        own_s = 0.0
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if _annotation(ev):
                    continue   # a host span mirrored onto the device's timeline
                dev_iv.append((start, start + dur))
                by_name[name] = by_name.get(name, 0.0) + dur * 1e-9
                if base_name(name) in own_names:
                    own_s += dur * 1e-9
            elif name in HOST_SPANS:
                host.append((start, start + dur, name))
        dev_iv.sort()
        merged = []
        for a, b in dev_iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_s = sum(b - a for a, b in merged) * 1e-9
        # idle gaps between device intervals, each put down to the innermost
        # host span open at its start
        host.sort()
        starts = [h[0] for h in host]
        idle = {}
        for (_, a), (b, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(starts, a)
            best = None
            for h in host[max(0, i - 64):i]:
                if h[0] <= a < h[1] and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            label = best[2] if best else "no span"
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
        window_s = self.t1 - self.t0
        self.prof = None
        return dict(busy_s=busy_s, window_s=window_s, own_s=own_s, n_device_events=len(dev_iv),
                    device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                    idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1])[:10])
