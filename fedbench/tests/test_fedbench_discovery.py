"""Every cell's files are found by name, and BENCHMARK.json keeps to its
contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from fedbench.harness import cell, spec

BENCH = spec.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fedbench"]
    assert BENCH["command"] == ["python3", "fedbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("fedbench/") and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_config_is_used_and_its_file_found():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = spec._load_json(spec.ROOT / c["file"])
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_and_metrics(workload):
    c = spec.load_cell(workload)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], workload)
        assert callable(spec.metric_reader(m["name"]))
    assert c.limits and all(isinstance(v, float) for v in c.limits.values())


def test_unknown_workload_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_read_nothing_where_nothing_was_recorded(metric):
    empty = cell.Run(protocol="none", window_s=0.0, timings=[], records=[],
                     useful_flops=0.0, arena_width=1024, leaf_sizes=[1024], learners=1)
    assert spec.metric_reader(metric)(empty) is None
