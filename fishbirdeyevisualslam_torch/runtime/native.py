"""ctypes bindings for the port's native C++ runtime (``csrc/fbev_runtime.cc``,
a copy of the JAX package's ``native/fbev_runtime.cc``):

  * :class:`AsyncPipeline` — the reference's Tracking -> LocalMapping ->
    LoopClosing thread/queue architecture (``System.cc:96-111``) as an N-stage
    native pipeline with Python stage callbacks, per-stage abort flags
    (InterruptBA analog) and backpressure;
  * :class:`Prefetcher` — a background dataset file loader (PGM parsed
    natively).

The library is compiled with ``g++ -O2 -std=c++17 -fPIC -shared -pthread`` at
first use into ``build/runtime/`` at the root of the checkout, named by a hash
of its source and flags, as ``_cuda.py`` builds the kernels.  There is no
Python fallback: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, List

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fbev_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "runtime"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_STAGE_FN = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_long, ctypes.c_void_p)


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfbev_runtime-{digest}.so"


def build_library() -> Path:
    """Compile the runtime unless its library exists; raises with the
    compiler's output if ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_library() -> ctypes.CDLL:
    """The runtime's library, built if missing."""
    lib = ctypes.CDLL(str(build_library()))
    lib.fbev_pipeline_create.restype = ctypes.c_void_p
    lib.fbev_pipeline_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fbev_pipeline_set_stage.argtypes = [ctypes.c_void_p, ctypes.c_int, _STAGE_FN,
                                            ctypes.c_void_p]
    lib.fbev_pipeline_submit.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.fbev_pipeline_signal_abort.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fbev_stage_abort_requested.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fbev_stage_abort_requested.restype = ctypes.c_int
    lib.fbev_pipeline_processed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fbev_pipeline_processed.restype = ctypes.c_long
    lib.fbev_pipeline_queue_depth.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fbev_pipeline_queue_depth.restype = ctypes.c_int
    lib.fbev_pipeline_flush.argtypes = [ctypes.c_void_p]
    lib.fbev_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.fbev_prefetch_create.restype = ctypes.c_void_p
    lib.fbev_prefetch_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                         ctypes.c_int]
    lib.fbev_prefetch_next.restype = ctypes.c_int
    lib.fbev_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fbev_prefetch_release.restype = ctypes.c_int
    lib.fbev_prefetch_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.fbev_prefetch_outstanding.restype = ctypes.c_int
    lib.fbev_prefetch_outstanding.argtypes = [ctypes.c_void_p]
    lib.fbev_prefetch_destroy.argtypes = [ctypes.c_void_p]
    return lib


class AsyncPipeline:
    """N-stage pipeline; stage callbacks receive (stage_idx, item_id) and run
    in the stage's native worker thread.  An exception a callback raises is
    printed by ctypes and dropped: callers catch their own."""

    def __init__(self, stage_fns: List[Callable[[int, int], None]], capacity: int = 64):
        self._lib = get_library()
        self._cb_refs = []
        self._p = ctypes.c_void_p(self._lib.fbev_pipeline_create(len(stage_fns), capacity))
        for i, fn in enumerate(stage_fns):
            cb = _STAGE_FN(lambda st, item, _u, f=fn: f(st, item))
            self._cb_refs.append(cb)  # the C side holds only the pointer
            self._lib.fbev_pipeline_set_stage(self._p, i, cb, None)

    @property
    def is_native(self) -> bool:
        return True

    def _handle(self):
        if not self._p:
            raise RuntimeError("the pipeline is closed")
        return self._p

    def submit(self, item: int):
        """Queue ``item`` into stage 0; blocks while that queue is full."""
        self._lib.fbev_pipeline_submit(self._handle(), item)

    def signal_abort(self, stage: int):
        self._lib.fbev_pipeline_signal_abort(self._handle(), stage)

    def abort_requested(self, stage: int) -> bool:
        return bool(self._lib.fbev_stage_abort_requested(self._handle(), stage))

    def processed(self, stage: int) -> int:
        return self._lib.fbev_pipeline_processed(self._handle(), stage)

    def queue_depth(self, stage: int) -> int:
        return self._lib.fbev_pipeline_queue_depth(self._handle(), stage)

    def flush(self):
        """Wait until every submitted item has passed the last stage (at once
        once closed: close() drains the queues)."""
        if self._p:
            self._lib.fbev_pipeline_flush(self._p)

    def close(self):
        """Stop the workers (after the items already queued) and free the pipeline."""
        if self._p:
            self._lib.fbev_pipeline_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Prefetcher:
    """Background dataset file loader (``fbev_prefetch_*``): a native worker
    thread reads files ahead of the consumer into a bounded buffer, parsing
    binary PGM (P5) headers in C.

    Usage::

        pf = Prefetcher(paths)
        for _ in paths:
            arr = pf.next()          # (H, W) uint8 for PGM, (N,) bytes else
        pf.close()

    ``next()`` copies into numpy and releases the native buffer at once, so
    the C side's outstanding list stays empty (``outstanding()`` exposes the
    count for tests).
    """

    def __init__(self, paths, capacity: int = 8):
        self.paths = [os.fspath(p) for p in paths]
        self._lib = get_library()
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._p = ctypes.c_void_p(self._lib.fbev_prefetch_create(arr, len(self.paths), capacity))

    @property
    def is_native(self) -> bool:
        return True

    def outstanding(self) -> int:
        if not self._p:
            raise RuntimeError("the prefetcher is closed")
        return self._lib.fbev_prefetch_outstanding(self._p)

    def next(self):
        """The next file: an (H, W) uint8 array for binary PGM, raw bytes
        otherwise; None when exhausted or unreadable."""
        import numpy as np
        if not self._p:
            raise RuntimeError("the prefetcher is closed")
        data = ctypes.POINTER(ctypes.c_uint8)()
        length, w, h = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
        ok = self._lib.fbev_prefetch_next(self._p, ctypes.byref(data), ctypes.byref(length),
                                          ctypes.byref(w), ctypes.byref(h))
        if not ok:
            return None
        buf = np.ctypeslib.as_array(data, shape=(length.value,)).copy()
        self._lib.fbev_prefetch_release(self._p, data)
        if w.value > 0 and h.value > 0:
            return buf.reshape(h.value, w.value)
        return buf

    def close(self):
        if self._p:
            self._lib.fbev_prefetch_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
