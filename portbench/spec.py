"""What a run looks up by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits and its metrics' readers.
A new configuration, mix or metric is a new file here plus its entries in
``BENCHMARK.json``; nothing in the harness names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def build_config(config_module, data: dict):
    """``config_module.SystemConfig`` from a configuration file's ``config``:
    every field of every group must be given, so that a change of the
    port's defaults cannot change what a cell runs."""
    cfg = config_module.SystemConfig()
    groups = {}
    if set(data) != {f.name for f in dataclasses.fields(cfg)}:
        raise ValueError(f"config groups {sorted(data)} are not SystemConfig's")
    for group, values in data.items():
        sub = getattr(cfg, group)
        names = {f.name for f in dataclasses.fields(sub)}
        if set(values) != names:
            raise ValueError(f"config group {group!r}: missing {sorted(names - set(values))}, "
                             f"unknown {sorted(set(values) - names)}")
        groups[group] = dataclasses.replace(
            sub, **{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})
    return cfg.replace(**groups)


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: with ``trace`` the per-layer
    metrics that list it (or, with no list, that move an end-to-end metric it
    reports), else its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def listed(m):
        return workload in m["workloads"] if "workloads" in m else m["moves"] in names
    return [m for m in bench["per_layer"] if listed(m)]


def reader(name: str, root: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
