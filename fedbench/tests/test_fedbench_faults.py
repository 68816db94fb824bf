"""A run with the timed path broken underneath comes out not correct: once
for each fault a training cell can have.  The faults are planted in the
program (the port's optimizer step and loss); the card is not looked for."""

from __future__ import annotations

import time

import pytest
import torch

from fedbench.harness import cell, spec
from fedbench.tests.toy import INT8, toy_cell

CELLS = [w["name"] for w in spec.manifest()["workloads"]] + [INT8]


def _unchanged_state(monkeypatch):
    from repro_torch.optim import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "apply",
                        lambda self, params, grads, state: (params, state))


def _half_batch(monkeypatch):
    from repro_torch.models import transformer

    whole = transformer.lm_loss

    def half(params, batch, cfg, **kw):
        n = batch["tokens"].shape[0] // 2
        return whole(params, {k: v[:n] for k, v in batch.items()}, cfg, **kw)

    monkeypatch.setattr(transformer, "lm_loss", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = cell.run(toy_cell(workload), 2**31 + 202, 0.1, False, torch.device("cpu"),
                   time.perf_counter())
    assert not res["correct"], res["checks"]
