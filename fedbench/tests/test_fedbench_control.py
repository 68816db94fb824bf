"""The control (the reference in the program's place, computing its products
in float8, the precision below the configuration's bfloat16) and the
half-batch fault fail at least one compared number: at toy size on the host
where the toy separates them, at each cell's own size on the card."""

from __future__ import annotations

import json

import pytest
import torch

from fedbench.harness import check, controls, spec
from fedbench.tests.toy import toy_cell

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return not check.verdict(numbers, limits)[0]


@pytest.mark.parametrize("workload", ["lm-sync-f32", "lm-async-f32"])
def test_toy_control_and_fault_fail(workload):
    c = toy_cell(workload)
    for seed in (1, 2):
        got = controls.readings(c, seed, torch.device("cpu"))
        assert _fails(got["control_fp8"], c.limits) and _fails(got["half_batch"], c.limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_fault_fail_at_the_cells_size(workload, seed, card):
    c = spec.load_cell(workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = controls.readings(c, seed, card)
    print(json.dumps({"workload": workload, "seed": seed, **got}), flush=True)
    assert _fails(got["control_fp8"], c.limits) and _fails(got["half_batch"], c.limits), got
