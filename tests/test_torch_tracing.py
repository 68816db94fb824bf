"""Spans of the port's controller and learners (``core/tracing.py``), on the host.

Without a profiler the journal holds no ``span.*`` record and the records it
holds are the ones it held before spans: under the journal's counter clock a
small sync and async federation's JSONL equals the JAX reference's, which
has no spans, byte for byte (the stress harness of
``tests/test_torch_stress.py``), and a federation of training learners
journals the same records traced and untraced once the spans are taken out.
Under ``torch.profiler.profile`` every train task's spans form one chain
under its task id, children lie inside their parents, an async update's
spans cover its ``dispatch``-to-``aggregate`` interval, and a
``record_function`` marker opened inside a span lands inside it on the
profiler's clock.
"""

from __future__ import annotations

import itertools
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro.core import FaultSpec as JFaultSpec
from repro_torch.core import (
    AsyncProtocol,
    Channel,
    Controller,
    EventJournal,
    FaultSpec,
    Learner,
    SyncProtocol,
    tracing,
)
from repro_torch.optim import sgd
from stress.harness import run_stress as run_stress_reference
from test_torch_stress import run_stress

CHAIN = ("dispatch.queue", "learner.recv", "learner.steps", "learner.upload",
         "engine.arrival_queue", "controller.ingest")


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


def _learner(i: int, width: int = 256) -> Learner:
    g = torch.Generator().manual_seed(i)
    x = torch.randn(256, 64, generator=g)
    y = x.sum(1, keepdim=True)

    def loss(p, b):
        return torch.mean((torch.tanh(b[0] @ p["w1"]) @ p["w2"] - b[1]) ** 2)

    return Learner(f"l{i}", loss, lambda p, b: {"eval_loss": loss(p, b)},
                   lambda bs: (x[:bs], y[:bs]), lambda: (x, y), sgd(0.01), 256, device="cpu")


def _federation(protocol: str, journal: EventJournal, n: int = 4, workers: int = 2,
                width: int = 256) -> Controller:
    proto = (SyncProtocol(local_steps=4, batch_size=128) if protocol == "sync"
             else AsyncProtocol(local_steps=4, batch_size=128))
    ctrl = Controller(protocol=proto, store_mode="arena", arena_n_max=n,
                      max_dispatch_workers=workers, journal=journal, device="cpu")
    g = torch.Generator().manual_seed(0)
    ctrl.set_initial_model({"w1": torch.randn(64, width, generator=g) * 0.1,
                            "w2": torch.zeros(width, 1)})
    for i in range(n):
        ctrl.register_learner(_learner(i, width))
    return ctrl


def _run(protocol: str, journal: EventJournal, traced: bool, **kw) -> list[dict]:
    ctrl = _federation(protocol, journal, **kw)
    try:
        if traced:
            with _profiling():
                _drive(ctrl, protocol)
        else:
            _drive(ctrl, protocol)
    finally:
        ctrl.shutdown()
    return journal.records()


def _drive(ctrl: Controller, protocol: str) -> None:
    if protocol == "sync":
        ctrl.engine.run(rounds=2)
    else:
        ctrl.engine.run(total_updates=8)


def _spans(records: list[dict]) -> list[dict]:
    return [r for r in records if r["kind"].startswith("span.")]


def _unspanned(records: list[dict]) -> list[dict]:
    """The records that are not spans, numbered again in their order."""
    return [{**r, "seq": i} for i, r in enumerate(r for r in records
                                                 if not r["kind"].startswith("span."))]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("protocol", ["sync", "async"])
def test_the_journal_is_the_references_once_spans_are_taken_out(protocol, traced, tmp_path):
    tpath, jpath = tmp_path / "port.jsonl", tmp_path / "reference.jsonl"
    if traced:
        with _profiling():
            run_stress(protocol, 8, 2, FaultSpec(seed=7), str(tpath))
    else:
        run_stress(protocol, 8, 2, FaultSpec(seed=7), str(tpath))
    run_stress_reference(protocol=protocol, learners=8, rounds=2, spec=JFaultSpec(seed=7),
                         journal_path=str(jpath))
    records = EventJournal.read_jsonl(str(tpath))
    assert bool(_spans(records)) == traced
    assert EventJournal().to_jsonl(_unspanned(records)) == jpath.read_text()


@pytest.mark.parametrize("protocol", ["sync", "async"])
def test_spans_leave_the_other_records_as_they_were(protocol):
    def journal():
        counter = itertools.count()
        return EventJournal(capacity=1 << 14, clock=lambda: float(next(counter)))

    plain = _run(protocol, journal(), traced=False, workers=1)
    traced = _run(protocol, journal(), traced=True, workers=1)
    assert not _spans(plain) and _spans(traced)
    # The counter clock is read once a record, so the traced run's non-span
    # records carry the same stamps; only the sequence numbers move.
    assert EventJournal().to_jsonl(_unspanned(traced)) == EventJournal().to_jsonl(plain)


@pytest.mark.parametrize("protocol", ["sync", "async"])
def test_every_train_task_has_its_chain_and_children_lie_in_parents(protocol):
    records = _run(protocol, EventJournal(capacity=1 << 14), traced=True)
    spans = _spans(records)
    by_task: dict = {}
    for r in spans:
        assert r["t"] <= r["t_end"], r
        by_task.setdefault(r["task"], []).append(r)
    train = [r["task"] for r in spans
             if r["kind"] == "span.dispatch.queue" and r["task_kind"] == "train"]
    dispatched = [r for r in records if r["kind"] == "dispatch"]
    assert len(train) == len(dispatched) > 0
    for task in train:
        kinds = {r["kind"][len("span."):] for r in by_task[task]}
        assert set(CHAIN) <= kinds, (task, kinds)
        assert len({r["learner"] for r in by_task[task]}) == 1
    if protocol == "sync":
        evals = [r for r in spans if r["kind"] == "span.learner.eval"]
        assert len(evals) == 2 * 4
    for child in spans:
        if child["parent"] is None:
            continue
        parents = [p for p in by_task[child["task"]]
                   if p["kind"] == f"span.{child['parent']}"
                   and p["t"] <= child["t"] and child["t_end"] <= p["t_end"]]
        assert parents, child


def _coverage(records: list[dict]) -> list[float]:
    """Each community update's share of its trigger's ``dispatch``-to-
    ``aggregate`` interval covered by the spans of the trigger's task."""
    spans = _spans(records)
    tasks: dict = {}  # learner -> its train task ids, in dispatch order
    for r in sorted(spans, key=lambda r: r["task"] if r["task"] is not None else -1):
        if r["kind"] == "span.dispatch.queue" and r["task_kind"] == "train":
            tasks.setdefault(r["learner"], []).append(r["task"])
    dispatches: dict = {}
    shares = []
    for r in records:
        if r["kind"] == "dispatch":
            dispatches.setdefault(r["learner"], []).append(r["t"])
        elif r["kind"] == "aggregate":
            lid = r["trigger"]
            task = max(s["task"] for s in spans if s["kind"] == "span.controller.ingest"
                       and s["learner"] == lid and s["t"] <= r["t"])
            lo = dispatches[lid][tasks[lid].index(task)]
            hi = r["t"]
            covered, reach = 0.0, lo
            for s in sorted((s for s in spans if s["task"] == task), key=lambda s: s["t"]):
                start, end = max(s["t"], reach), min(s["t_end"], hi)
                if end > start:
                    covered += end - start
                reach = max(reach, end)
            shares.append(covered / (hi - lo))
    return shares


def test_an_async_updates_spans_cover_its_latency():
    records = _run("async", EventJournal(capacity=1 << 14), traced=True)
    shares = _coverage(records)
    assert len(shares) >= 8
    assert statistics.median(shares) >= 0.95, shares


def test_a_marker_inside_a_span_lands_inside_it_on_the_profilers_clock():
    journal = EventJournal()
    with _profiling() as prof:
        with tracing.bind(journal, task=0):
            with tracing.Span("probe"):
                time.sleep(0.005)
                with record_function("inside"):
                    torch.ones(8).sum()
                time.sleep(0.005)
    (rec,) = journal.records()
    (mark,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert rec["kind"] == "span.probe" and rec["task"] == 0 and rec["parent"] is None
    assert rec["t"] * 1e9 <= mark.start_ns() <= mark.end_ns() <= rec["t_end"] * 1e9


def test_a_span_open_across_the_profilers_start_or_stop_records_nothing():
    journal = EventJournal()
    with tracing.bind(journal):
        with tracing.Span("before") as before:
            prof = _profiling()
            prof.start()
        with tracing.Span("after"):
            prof.stop()
        assert not tracing.active()
        with tracing.Span("off") as off:
            pass
        tracing.close("marked", tracing.mark())
    assert journal.records() == []
    assert not before.recording and not off.recording
    assert off.seconds >= 0.0


def test_the_channels_counters_are_the_spans_seconds():
    channel = Channel(device="cpu")
    journal = EventJournal()
    row = torch.arange(1024, dtype=torch.float32)
    with _profiling(), tracing.bind(journal):
        envelope = channel.upload(row)
        channel.recv_upload(envelope)
        bc = channel.broadcast(params={"w": row}, version=3)
        channel.recv(bc.to())
    spans = {r["kind"][len("span."):]: r for r in journal.records()}
    assert set(spans) == {"learner.encode", "controller.decode", "controller.broadcast",
                          "learner.recv"}
    for name, counter in [("learner.encode", "upload_serialize_s"),
                          ("controller.decode", "upload_deserialize_s"),
                          ("controller.broadcast", "serialize_s"),
                          ("learner.recv", "deserialize_s")]:
        seconds = channel.telemetry.value(f"channel.{counter}")
        assert seconds == pytest.approx(spans[name]["t_end"] - spans[name]["t"], abs=1e-6)
    assert spans["controller.broadcast"]["version"] == 3
    assert spans["learner.encode"]["bytes"] == spans["controller.decode"]["bytes"] == 4096


def test_a_learners_spans_reach_the_journal_bound_to_its_task_only_under_the_profiler():
    ctrl = _federation("sync", EventJournal(capacity=0), n=1, workers=1)
    learner = ctrl._learners["l0"]
    task = ctrl.protocol.size_task(0, {}, wire_s=0.0)
    journal = EventJournal()
    with tracing.bind(journal, task=5, learner="l0"):
        learner.fit(ctrl.global_params, task)
        assert journal.records() == []
        with _profiling():
            traced = learner.fit(ctrl.global_params, task)
    ctrl.shutdown()
    records = journal.records()
    assert [r["kind"] for r in records] == ["span.learner.steps", "span.learner.encode",
                                            "span.learner.upload"]
    assert {(r["task"], r["learner"]) for r in records} == {(5, "l0")}
    steps, encode, upload = records
    assert steps["steps"] == 4 and steps["parent"] is None
    assert encode["parent"] == "learner.upload"
    assert upload["t"] <= encode["t"] <= encode["t_end"] <= upload["t_end"]
    assert 0.0 <= steps["launch_s"] <= steps["t_end"] - steps["t"]
    # The thread's CPU time lies inside the span's wall time, to one tick of a
    # kernel that counts thread time in 10 ms ticks.
    for rec in records:
        assert 0.0 <= rec["cpu_s"] <= rec["t_end"] - rec["t"] + 0.011
    assert traced.seconds_per_step * 4 == pytest.approx(steps["t_end"] - steps["t"], abs=1e-6)
