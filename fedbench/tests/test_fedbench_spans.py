"""The span readers on a synthetic run: nothing where the program journaled
no span, and the right sums, means and union where it did."""

from __future__ import annotations

import pytest

from fedbench.harness import cell, spans, spec
from fedbench.harness.trace import TraceSummary

SPAN_METRICS = [m["name"] for m in spec.manifest()["per_layer"]
                if m["name"].split(".")[0] in ("task_queue_s", "learner_steps_s", "downlink_s",
                                               "uplink_s", "commit_wait_s", "controller_busy")]
T0 = 1_700_000_000.0


def _span(name: str, t: float, t_end: float, **fields) -> dict:
    return {"seq": 0, "t": T0 + t, "t_end": T0 + t_end, "kind": f"span.{name}", "task": 0,
            "learner": "learner_000", "parent": None, **fields}


def _run(protocol: str, records: list[dict], traced_steps: int = 2, window_s: float = 10.0,
         trace: bool = True) -> cell.Run:
    summary = TraceSummary(window_s=window_s, busy_s=window_s / 2, copy_s=0.0, ops=[],
                           host_t0=T0, ns_t0=0) if trace else None
    return cell.Run(protocol=protocol, window_s=20.0, timings=[], records=records,
                    useful_flops=0.0, arena_width=1024, leaf_sizes=[1024], learners=8,
                    trace=summary, traced_steps=traced_steps)


RECORDS = [
    _span("dispatch.queue", 0.0, 2.0, task_kind="train", depth=0),
    _span("dispatch.queue", 1.0, 5.0, task_kind="train", depth=1),
    _span("dispatch.queue", 6.0, 6.5, task_kind="eval", depth=0),
    _span("dispatch.queue", 5.0, 8.5, task_kind="train", depth=5),  # after the first aggregate
    _span("learner.recv", 2.0, 2.25, bytes=8),
    _span("learner.recv", 5.0, 5.5, bytes=8),
    _span("learner.steps", 2.25, 3.25, steps=2, launch_s=0.1),
    _span("learner.steps", 5.5, 8.5, steps=2, launch_s=0.1),
    _span("learner.upload", 3.25, 3.5, bytes=8),
    _span("controller.broadcast", 0.5, 1.0, version=0, bytes=8),
    _span("controller.ingest", 3.5, 4.0, bytes=8),
    _span("controller.aggregate", 3.75, 4.5, version=1),
    _span("controller.commit_wait", 4.0, 4.5),
    _span("controller.commit_wait", 9.0, 9.5),
    _span("controller.broadcast", 9.75, 12.0, version=1, bytes=8),  # runs past the window
    _span("learner.steps", -3.0, -1.0, steps=2, launch_s=0.1),  # before the window
    {"seq": 1, "t": T0 + 1.0, "kind": "dispatch", "learner": "learner_000"},
    {"seq": 2, "t": T0 + 4.5, "kind": "aggregate", "trigger": "learner_000"},
]


def test_the_readers_cover_the_span_metrics():
    assert len(SPAN_METRICS) == 10


@pytest.mark.parametrize("metric", SPAN_METRICS)
@pytest.mark.parametrize("trace", [False, True])
def test_no_span_no_reading(metric, trace):
    plain = [r for r in RECORDS if not r["kind"].startswith("span.")]
    protocol = "sync" if metric.endswith(".sync") else "async"
    assert spec.metric_reader(metric)(_run(protocol, plain, trace=trace)) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_reader_reads_only_its_protocol(metric):
    other = "async" if metric.endswith(".sync") else "sync"
    assert spec.metric_reader(metric)(_run(other, RECORDS)) is None


@pytest.mark.parametrize("suffix, protocol", [("sync", "sync"), ("async", "async")])
def test_sums_and_means(suffix, protocol):
    run = _run(protocol, RECORDS)

    def read(name):
        return spec.metric_reader(f"{name}.{suffix}")(run)

    # Train tasks only; async leaves out those submitted before the window's
    # first aggregate.
    queue = (2.0 + 4.0 + 3.5) / 3 if protocol == "sync" else 3.5
    assert read("task_queue_s") == pytest.approx(queue)
    assert read("learner_steps_s") == pytest.approx((1.0 + 3.0) / 2)  # inside the window
    assert read("downlink_s") == pytest.approx((0.5 + 2.25 + 0.25 + 0.5) / 2)
    assert read("uplink_s") == pytest.approx((0.25 + 0.5) / 2)


def test_the_async_queue_needs_an_aggregate_in_the_window():
    no_aggregate = [r for r in RECORDS if r["kind"] != "aggregate"]
    assert spec.metric_reader("task_queue_s.async")(_run("async", no_aggregate)) is None


def test_the_span_metrics_are_read_only_under_the_trace():
    """The port journals spans only while the profiler collects, so these
    metrics carry the source the harness reads only in a traced run."""
    per_layer = {m["name"]: m for m in spec.manifest()["per_layer"]}
    assert {per_layer[name]["source"] for name in SPAN_METRICS} == {"device_trace"}


def test_commit_wait_and_controller_busy():
    run = _run("async", RECORDS)
    assert spec.metric_reader("commit_wait_s.async")(run) == pytest.approx(0.5)
    # ingest 3.5-4.0 and aggregate 3.75-4.5 overlap: 1.0 s; broadcasts 0.5 s and
    # 9.75-10.0 inside the window: 1.75 s of 10.
    assert spec.metric_reader("controller_busy.async")(run) == pytest.approx(17.5)


def test_helpers_select_the_window():
    run = _run("async", RECORDS)
    assert len(spans.window_spans(run, "learner.steps")) == 2
    assert spans.window_spans(run, "dispatch.queue", task_kind="eval")[0]["depth"] == 0
    assert spans.total_s(run, "learner.recv") == pytest.approx(0.75)
    assert spans.per_step_s(_run("async", RECORDS, traced_steps=0), "learner.recv") is None
    assert spans.mean_s(run, "no.such.span") is None
    assert spans.union_s(run, "learner.steps", "learner.recv") == pytest.approx(0.25 + 1.0 + 3.5)
