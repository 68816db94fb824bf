"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names every cell; a cell names its
configuration and its traffic mix.  Each of those, each cell's correctness
limits and each per-layer metric lives in a file of its own under
``fedbench/``, found by the name alone:

* ``configs/<config>.json``: the model's sizes as they are run;
* ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
* ``limits/<workload>.json``: under ``"limits"``, the limit of each number
  ``correct`` compares (beside them, the readings they were set from);
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

So a later change adds a cell or a metric by adding files, never by editing
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Callable

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(Exception):
    """A cell, or one of its files, is missing or malformed."""


def _load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    with path.open() as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def manifest(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json``."""
    return _load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The named workload with its configuration, traffic, limits and the
    metrics it reports."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_load_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(BENCH_DIR / "limits" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def metric_reader(name: str) -> Callable[[Any], float | None]:
    """``read`` of ``metrics/<name>.py``, loaded from its file (the name may
    hold dots, so it is not imported as a module path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{name}.py for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"fedbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
