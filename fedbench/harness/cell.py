"""One run of one cell: set-up, the measured window, the traced window, the
reference, and the result.

Set-up builds the data and the initial model on the device from the seed,
builds the federation and drives its first ``check_steps`` steps through
the window's own ``engine.run`` (the first step warms every shape the
window uses); their readings are kept for the comparison.  The window does
a fixed amount of work for its ``seconds``: ``seconds`` times the mix's
``window_steps_per_s`` rounds, back to back (round-based protocols), or as
many community updates in one ``engine.run(total_updates=n)``, the tasks
still in flight at its end drained inside it (async); the rate is today's,
so the window lasts about ``seconds``.  With ``trace``, the profiler
covers the window's first ``trace_rounds`` rounds, or its first
``trace_seconds``.  After the window the peak memory is read, the program
is shut down and freed, and the reference follows the set-up steps.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time

import torch

from fedbench.harness import check, controls, counts, spec, system, traffic, weights
from fedbench.harness.trace import Tracer, TraceSummary
from fedbench.reference import fl


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""

    protocol: str
    window_s: float
    timings: list  # RoundTimings of every round or update in the window
    records: list[dict]  # journal records of the window
    useful_flops: float
    arena_width: int
    leaf_sizes: list[int]
    learners: int
    trace: TraceSummary | None = None
    traced_steps: int = 0  # rounds or updates committed in the traced window


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program_steps(fed: system.Federation, changes: list[dict], timings: list,
                   k: int) -> list[dict]:
    """The program's readings of its first ``k`` steps."""
    steps = [{"train_losses": {}, "eval_loss": None, "change": c} for c in changes[:k]]
    uploads = fed.uploads()
    if fed.continuous:
        records = [r for r in fed.records() if r["kind"] == "aggregate"][:k]
        losses = {}
        for up in uploads:
            losses.setdefault(up.update.learner_id, []).append(up.update.metrics["train_loss"])
        seen: dict[str, int] = {}
        for step, rec in zip(steps, records):
            lid = rec["trigger"]
            step["train_losses"][system.learner_index(lid)] = losses[lid][seen.get(lid, 0)]
            seen[lid] = seen.get(lid, 0) + 1
    else:
        for r, step in enumerate(steps):
            for up in uploads:
                if int(up.update.round_id) == r:
                    step["train_losses"][system.learner_index(up.update.learner_id)] = \
                        up.update.metrics["train_loss"]
            step["eval_loss"] = timings[r].metrics["eval_loss"]
    return steps


def _window(fed: system.Federation, t: dict, seconds: float,
            trace: bool) -> tuple[float, list, TraceSummary | None, int, float]:
    """The measured window: ``(seconds, timings, trace, traced steps, t0)``."""
    tracer = Tracer() if trace else None
    summary, traced = None, 0
    steps = max(1, round(seconds * t["window_steps_per_s"]))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not fed.continuous:
        timings = []
        for _ in range(steps):
            if tracer is not None and not timings:
                tracer.start()
            timings += fed.run_rounds(1)
            if tracer is not None and len(timings) == min(t["trace_rounds"], steps):
                summary, traced, tracer = tracer.stop(), len(timings), None
        return time.perf_counter() - t0, timings, summary, traced, t0
    # The updates still in flight when the n-th commits (one a learner but
    # the last arrival's) drain inside the same engine.run.
    n = max(1, steps - (t["learners"] - 1))
    out: list = []
    worker = threading.Thread(target=lambda: out.extend(fed.run_updates(n)))
    if tracer is not None:
        tracer.start()
    worker.start()
    if tracer is not None:
        worker.join(min(t["trace_seconds"], seconds))
        summary = tracer.stop()
    worker.join()
    elapsed = time.perf_counter() - t0
    return elapsed, out, summary, traced, t0


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        process_t0: float) -> dict:
    """One run; returns the result line's fields (and ``checks``)."""
    t = cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = t["check_steps"]
    marks = [("imports", time.perf_counter())]
    shards = traffic.make_shards(t, cell.config["vocab_size"], seed, device)
    theta0 = weights.draw(cell.config, seed, device)
    _sync(device)
    marks.append(("data_and_weights", time.perf_counter()))
    fed = system.Federation(cell.config, t, shards, theta0, device)
    del theta0
    _sync(device)
    marks.append(("federation", time.perf_counter()))
    changes: list[dict] = []
    fed.record_steps(k, changes)
    warm = fed.run_updates(max(k, t["warmup_updates"])) if fed.continuous else fed.run_rounds(k)
    marks.append(("check_steps", time.perf_counter()))
    prog_steps = _program_steps(fed, changes, warm, k)
    final_row, manifest = fed.final_row, fed.manifest
    schedule = system.async_schedule(fed.records(), k) if fed.continuous else None
    n_warm_records = len(fed.records())

    elapsed, timings, summary, traced, t0 = _window(fed, t, seconds, trace)
    setup_s = t0 - process_t0
    marks.append(("to_window", t0))
    phases, last = {}, process_t0
    for name, at in marks:
        phases[name], last = at - last, at
    records = fed.records()[n_warm_records:]
    if fed.continuous and summary is not None:
        lo, hi = summary.host_t0, summary.host_t0 + summary.window_s
        traced = sum(1 for r in records if r["kind"] == "aggregate" and lo <= r["t"] <= hi)
    steps_done = len(timings)
    tokens = t["batch_seqs"] * t["seq_len"] * t["local_steps"]
    trained = steps_done * tokens * (1 if fed.continuous else t["learners"])
    evaluated = 0 if fed.continuous else steps_done * t["learners"] * t["eval_seqs"] * t["seq_len"]
    info = Run(protocol=t["protocol"], window_s=elapsed, timings=timings,
               records=records,
               useful_flops=counts.useful_flops(cell.config, t["seq_len"], trained, evaluated),
               arena_width=fed.arena_width, leaf_sizes=fed.leaf_sizes, learners=t["learners"],
               trace=summary, traced_steps=traced)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    fed.shutdown()
    del fed, shards, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_steps = controls.reference_steps(cell, seed, device, schedule=schedule)
    row = final_row.to(device)
    prog_steps[-1]["theta"] = {s.name: row[s.offset: s.offset + s.size].view(s.shape)
                               for s in manifest.specs}
    shards = traffic.make_shards(t, cell.config["vocab_size"], seed, device)
    prog_steps[-1]["judged"] = fl.judge(prog_steps[-1]["theta"], shards, t, cell.config)
    numbers = check.readings(prog_steps, ref_steps)
    correct, shown = check.verdict(numbers, cell.limits)
    kept = check.kept_leaves(ref_steps[0]["change"])
    left_out = [name for name in ref_steps[0]["change"] if name not in kept]
    return {"correct": correct, "attempted": steps_done, "failed": 0, "info": info,
            "setup_s": setup_s, "memory_peak_bytes": peak, "checks": shown,
            "readings": {k: v for k, v in numbers.items() if k not in cell.limits},
            "left_out": left_out, "setup_phases": phases, "schedule": schedule,
            "rounds": None if info.protocol != "sync" else
            [[x.train_round_s, x.aggregation_s, x.eval_round_s, x.federation_round_s]
             for x in timings],
            "eval_loss": [s.metrics.get("eval_loss") for s in timings if s.metrics]}


def end_to_end(info: Run, setup_s: float) -> dict:
    """The cell's end-to-end metrics, measured by the host's clock."""
    out = {"setup_s": setup_s}
    if info.protocol == "sync":
        out["round_s"] = info.window_s / len(info.timings)
    else:
        aggs = [r for r in info.records if r["kind"] == "aggregate"]
        out["updates_per_s"] = len(aggs) / info.window_s
        dispatched: dict[str, float] = {}
        lat = []
        for r in info.records:
            if r["kind"] == "dispatch":
                dispatched[r["learner"]] = r["t"]
            elif r["kind"] == "aggregate":
                lat.append(r["t"] - dispatched[r["trigger"]])
        out["update_p95_s"] = system.p95(lat)
    return out


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
