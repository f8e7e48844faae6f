"""What the benchmark finds by name: the manifest, configurations, traffic
mixes, per-layer metric readers and each cell's limits.

- `BENCHMARK.json` at the root of the checkout: the cells (`workloads`),
  the end-to-end and per-layer metrics;
- `hopbench/configs/<config>.json`: one deployment each;
- `hopbench/traffic/<traffic>.json`: one traffic mix each;
- `hopbench/metrics/<metric>.py`: one reader per per-layer metric, a
  function `read(ctx)` returning the metric's value or None when the cell
  has nothing for it to read (hopbench/context.py says what `ctx` holds);
- `hopbench/limits/<workload>.json`: the limits of the numbers that decide
  a cell's `correct` (hopbench/judge.py);
- `hopbench/reference/plain/<system>.py`: the plain reference of a system
  that reference/systems.py does not hold (reference/check.py::system).

A new configuration, mix, metric or cell is a new file and an entry in
BENCHMARK.json; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"hopbench: {path} not found")
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, man: dict) -> dict:
    """The manifest's workload entry `name`."""
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"hopbench: no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in man['workloads']]})")


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def limits(workload: str, here: Path = HERE) -> dict:
    return _json(here / "limits" / f"{workload}.json")


def reader(metric: str, here: Path = HERE):
    """The `read` function of hopbench/metrics/<metric>.py (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"hopbench: no reader {path} for the per-layer metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"hopbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, workload: str, man: dict) -> bool:
    """Whether the cell `workload` reports this metric: those its
    `workloads` key lists, or without the key every cell that reports the
    end-to-end metric it moves (for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in man["end_to_end"] if m["name"] == moves)
    return reports(e2e, workload, man)


def metrics_of(workload: str, man: dict, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m for m in man[kind] if reports(m, workload, man)]
