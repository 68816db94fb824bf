"""Each cell at toy size on the port's host path: set-up, the window, the
reference and the result, as a run on the card makes them."""

from __future__ import annotations

import math
import time

import pytest
import torch

from fedbench.harness import cell, spec
from fedbench.tests.toy import INT8, toy_cell

CELLS = [w["name"] for w in spec.manifest()["workloads"]] + [INT8]


@pytest.mark.parametrize("workload", CELLS)
def test_toy_cell_runs_and_agrees_with_the_reference(workload):
    c = toy_cell(workload)
    res = cell.run(c, 2**31 + 101, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res["checks"]) == list(c.limits)
    e2e = cell.end_to_end(res["info"], res["setup_s"])
    assert {m["name"] for m in c.end_to_end} <= set(e2e)
    assert all(math.isfinite(v) and v > 0 for v in e2e.values())
    for m in c.per_layer:
        value = spec.metric_reader(m["name"])(res["info"])
        needs_trace = m["source"] == "device_trace"
        assert (value is None) == needs_trace, m["name"]
