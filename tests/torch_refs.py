"""The port's tests' expensive module fixtures, computed once per test run.

Under pytest-xdist every worker that runs a test of a module builds that
module's fixtures again, and the port's parity fixtures cost tens of
CPU-seconds each: their JAX references (a frame build, compiles of
``track_frame_core``, ``extract_dual`` and the pose LM) and the port's own
runs on the same inputs.  A module registers such a fixture's value with
``register``; its fixture asks for it with ``shared``.  The first worker
that asks computes the value and writes it, a picklable tree of numpy arrays
and tensors, into the run's shared temporary directory; the other workers
load the file.  A worker that finds a value being computed elsewhere first
computes the registered values nobody has started (those of modules with
tests selected in this run), the costliest first, then waits for it.  A run
without workers computes directly.
"""

import fcntl
import os
import pickle
from pathlib import Path

_REGISTRY = {}   # name -> (the registering test module's path, compute, cost)


def register(name: str, module_file: str, compute, cost: float = 0.0) -> None:
    """``compute()`` gives the value of the fixture ``name`` of the test
    module at ``module_file``; ``cost``, its wall seconds on one core, orders
    the values a waiting worker computes (the longest first, so that the run
    does not end waiting for one started late)."""
    _REGISTRY[name] = (str(Path(module_file).resolve()), compute, cost)


def _produce(root: Path, name: str, blocking: bool) -> bool:
    """Write ``name``'s file unless it exists; with ``blocking`` False, give
    up at once if another worker holds its lock.  True once the file exists."""
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB))
        except BlockingIOError:
            return False
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(_REGISTRY[name][1](), f)
            os.replace(tmp, path)
    return True


def shared(request, tmp_path_factory, name: str):
    """The value of the registered fixture ``name``, computed once per run."""
    if not hasattr(request.config, "workerinput"):   # no xdist worker: nothing to share
        return _REGISTRY[name][1]()
    root = tmp_path_factory.getbasetemp().parent       # the run's directory, above the workers'
    if not _produce(root, name, blocking=False):
        selected = {str(Path(str(item.fspath)).resolve()) for item in request.session.items}
        for other, (module, _, _) in sorted(_REGISTRY.items(), key=lambda kv: -kv[1][2]):
            if other != name and module in selected and not (root / f"{other}.pkl").exists():
                _produce(root, other, blocking=False)
        _produce(root, name, blocking=True)
    with open(root / f"{name}.pkl", "rb") as f:
        return pickle.load(f)
