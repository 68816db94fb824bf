"""The stress harness's twin on the port, held against the reference harness.

``run_stress`` below is ``tests/stress/harness.py`` restated on
``repro_torch``: the same ``SimLearner`` fleet (no training: each update is
a deterministic row keyed on ``(learner_id, round_id)`` with a
fault-injected step time), the same fault-stamping channel, churn between
engine runs, one dispatch worker and the journal's counter clock.  For each
of the six protocols, 64 learners × 3 rounds under fault seed 7 with churn,
upload loss and duplication, stragglers and bandwidth caps, the port's
journal JSONL must equal the reference harness's byte for byte, and the
fault counters and the staleness histogram must be equal; the final model's
squared error against the consensus target agrees within rtol 1e-5 (the two
frameworks sum the reduce over up to 64 rows in different orders).
"""

import hashlib
import itertools
import math
import zlib

import numpy as np
import pytest
import torch

from repro.core import FaultSpec as JFaultSpec
from repro_torch.core import (
    AsyncProtocol,
    BufferedAsyncProtocol,
    Controller,
    DeadlineCohortProtocol,
    EvalReport,
    EventJournal,
    FaultInjector,
    FaultSpec,
    FaultyChannel,
    Learner,
    LocalUpdate,
    ReputationProtocol,
    SemiSyncProtocol,
    SyncProtocol,
    Telemetry,
)
from stress.harness import STRESS_PROTOCOLS, target_value
from stress.harness import run_stress as run_stress_reference

_FAULT_COUNTERS = (
    "orphaned", "uploads_lost", "uploads_duplicated", "uploads_late",
    "deadline_fires", "dropouts", "rejoins", "stragglers",
)
CHAOS = dict(seed=7, dropout_rate=0.1, rejoin_rate=0.5, upload_loss_rate=0.05,
             upload_dup_rate=0.05, straggler_rate=0.2, bandwidth_min_gbps=0.05,
             bandwidth_max_gbps=10.0)


class SimLearner(Learner):
    """A learner that fabricates its update instead of training (the
    reference harness's ``SimLearner``, on the host)."""

    def __init__(self, learner_id: str, injector: FaultInjector, num_examples: int = 16):
        super().__init__(learner_id, loss_fn=None, eval_fn=None, data_fn=None,
                         eval_data_fn=None, optimizer=None, num_examples=num_examples,
                         device="cpu")
        self._injector = injector

    def fit(self, params, task) -> LocalUpdate:
        rid = int(task.round_id)
        sps = self._injector.step_time(self.learner_id, rid)
        value = (zlib.crc32(f"{self.learner_id}:{rid}".encode()) % 100_000) / 100_000.0
        row = torch.full((self._upload_pad,), value, dtype=torch.float32)
        upload = self._channel.upload(row, metadata={"learner_id": self.learner_id,
                                                     "round_id": rid})
        return LocalUpdate(learner_id=self.learner_id, round_id=rid, params=None,
                           num_examples=self.num_examples,
                           metrics={"train_loss": value, "local_steps": task.local_steps},
                           seconds_per_step=sps, upload=upload)

    def evaluate(self, params, round_id: int) -> EvalReport:
        return EvalReport(learner_id=self.learner_id, round_id=int(round_id),
                          metrics={"eval_loss": 0.0}, num_examples=self.num_examples)


def _make_protocol(name: str, learners: int, deadline_s: float):
    if name == "sync":
        return SyncProtocol(local_steps=1, batch_size=8)
    if name == "semi_sync":
        return SemiSyncProtocol(hyperperiod_s=0.05, batch_size=8, default_steps=1)
    if name == "async":
        return AsyncProtocol(local_steps=1, batch_size=8)
    if name == "buffered_async":
        return BufferedAsyncProtocol(buffer_k=max(1, min(16, learners - 1)), local_steps=1,
                                     batch_size=8)
    if name == "deadline":
        return DeadlineCohortProtocol(deadline_s=deadline_s, local_steps=1, batch_size=8,
                                      enforce_wall_clock=False)
    if name == "reputation":
        return ReputationProtocol(fraction=0.5, local_steps=1, batch_size=8)
    raise ValueError(f"unknown stress protocol {name!r}")


def run_stress(protocol: str, learners: int, rounds: int, spec: FaultSpec,
               journal_path: str, model_params: int = 64,
               deadline_s: float = 0.05) -> dict:
    """One deterministic stress run of the port; the reference's row keys."""
    open(journal_path, "w", encoding="utf-8").close()
    telemetry = Telemetry()
    injector = FaultInjector(spec, telemetry=telemetry)
    channel = FaultyChannel(injector, telemetry=telemetry, device="cpu")
    counter = itertools.count()
    journal = EventJournal(capacity=1 << 17, sink=journal_path,
                           clock=lambda: float(next(counter)))
    proto = _make_protocol(protocol, learners, deadline_s)
    ctrl = Controller(protocol=proto, channel=channel, store_mode="arena",
                      arena_n_max=learners, max_dispatch_workers=1, journal=journal,
                      admission_control=spec.adversarial_fraction > 0, device="cpu")
    ctrl.set_initial_model({"w": torch.zeros((model_params,), dtype=torch.float32)})
    fleet = {f"l{i:04d}": SimLearner(f"l{i:04d}", injector) for i in range(learners)}
    for lid, learner in fleet.items():
        cap = injector.bandwidth_cap(lid)
        if cap is not None:
            channel.set_learner_bandwidth(lid, cap)
        ctrl.register_learner(learner)
    continuous = bool(getattr(proto, "continuous", False))
    updates_per_round = max(1, math.ceil(learners / max(1, getattr(proto, "buffer_k", 1))))
    for r in range(rounds):
        if r > 0:
            leave, rejoin = injector.churn(r, sorted(ctrl._learners))
            for lid in leave:
                ctrl.deregister_learner(lid)
            for lid in rejoin:
                ctrl.register_learner(fleet[lid])
        if continuous:
            ctrl.engine.run(total_updates=updates_per_round)
        else:
            ctrl.engine.run(rounds=1)
    final_target = target_value(max(int(ctrl.round_id) - 1, 0))
    gbuf = ctrl.global_buffer.numpy()[:model_params]
    final_eval_loss = float(np.mean((gbuf - np.float32(final_target)) ** 2))
    ctrl.shutdown()
    staleness_hist: dict[str, int] = {}
    for rec in journal.records():
        if rec.get("kind") == "upload" and "staleness" in rec:
            key = str(int(rec["staleness"]))
            staleness_hist[key] = staleness_hist.get(key, 0) + 1
    with open(journal_path, "rb") as fh:
        sha = hashlib.sha256(fh.read()).hexdigest()
    return {
        "uploads": int(telemetry.value("channel.upload_messages")),
        "aggregates": int(ctrl.engine.aggregates_fired),
        "final_eval_loss": final_eval_loss,
        "staleness_hist": dict(sorted(staleness_hist.items())),
        "faults": {
            name: int(telemetry.value(f"engine.faults.{name}")) if name != "orphaned"
            else int(telemetry.value("engine.uploads.orphaned"))
            for name in _FAULT_COUNTERS
        },
        "journal_sha256": sha,
    }


@pytest.mark.parametrize("protocol", STRESS_PROTOCOLS)
def test_stress_journal_is_byte_identical_to_reference(protocol, tmp_path):
    tpath, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "reference.jsonl")
    got = run_stress(protocol, 64, 3, FaultSpec(**CHAOS), tpath)
    want = run_stress_reference(protocol=protocol, learners=64, rounds=3,
                                spec=JFaultSpec(**CHAOS), journal_path=jpath)
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        tlines, jlines = ft.read().splitlines(), fj.read().splitlines()
    assert len(tlines) == len(jlines)
    for i, (t, j) in enumerate(zip(tlines, jlines)):
        assert t == j, f"journal line {i}"
    assert got["journal_sha256"] == want["journal_sha256"]
    for key in ("uploads", "aggregates", "staleness_hist", "faults"):
        assert got[key] == want[key], key
    # The two frameworks sum the reduce over up to 64 rows in different orders.
    assert got["final_eval_loss"] == pytest.approx(want["final_eval_loss"], rel=1e-5)
    faults = got["faults"]
    assert faults["dropouts"] > 0 and faults["stragglers"] > 0
    assert faults["uploads_lost"] + faults["uploads_duplicated"] > 0
    assert got["staleness_hist"]
