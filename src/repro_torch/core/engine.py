"""The event-driven round engine: one arrival-driven loop.

The port of ``repro/core/engine.py`` for round-based policies (the sync
protocol of this slice).  :meth:`RoundEngine.run` consumes **typed events**
and delegates every protocol decision to the
:class:`~repro_torch.core.scheduler.ProtocolPolicy` hooks; the controller is
model-state + transport + store plumbing (``core/controller.py``); the engine
owns the dispatch executor and the control flow.

Event grammar:

* :class:`Dispatched` — a task left the controller for a learner;
* :class:`UploadArrived` — a learner's ``LocalUpdate`` came off the measured
  uplink, posted from an executor thread through :meth:`RoundEngine.post`;
  the loop ingests it and asks ``policy.should_aggregate``;
* :class:`AggregateFired` — the policy said aggregate (full-cohort FedAvg);
* :class:`Evaluated` — the post-aggregation eval fan-out reduced its reports.

The loop is the only consumer of the queue, so all state mutation is
serialized without protocol code touching a lock.  Learner work runs on a
``ThreadPoolExecutor``; CUDA work issued from those threads goes to the
default stream, which keeps it correct.  Continuous policies, deadlines,
the transport fault fates (``lost``/``dup``) and checkpoints are slice B of
the port: an arrival whose metadata carries a ``fault`` raises
``NotImplementedError``.  Adversarial fates (``core/faults.py``) ride on
``ok`` uploads and meet the admission screen and quarantine like any other.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any

from repro_torch.core.journal import EventJournal
from repro_torch.core.learner import EvalReport, LocalUpdate
from repro_torch.core.metrics import Telemetry
from repro_torch.core.scheduler import TrainTask

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from repro_torch.core.controller import Controller

__all__ = [
    "RoundTimings",
    "Dispatched",
    "UploadArrived",
    "UploadRejected",
    "UploadClipped",
    "LearnerQuarantined",
    "UploadRejectedError",
    "AggregateFired",
    "Evaluated",
    "EngineStopped",
    "RoundEngine",
    "reduce_eval",
]


class UploadRejectedError(Exception):
    """Raised by ``Controller.ingest`` when admission control rejects an upload.

    The engine loop catches it and treats the arrival like a lost upload:
    the quorum shrinks, reputation is penalized, a typed record is journaled.
    """

    def __init__(self, learner_id: str, reason: str, norm: float):
        super().__init__(f"upload from {learner_id!r} rejected: {reason} (norm={norm!r})")
        self.learner_id = learner_id
        self.reason = reason
        self.norm = norm


@dataclasses.dataclass
class RoundTimings:
    """The six per-operation wall-clock measurements of the paper's Figs 5-7."""

    round_id: int = -1
    train_dispatch_s: float = 0.0
    train_round_s: float = 0.0
    aggregation_s: float = 0.0
    eval_dispatch_s: float = 0.0
    eval_round_s: float = 0.0
    federation_round_s: float = 0.0
    metrics: dict = dataclasses.field(default_factory=dict)

    def as_row(self) -> dict:
        """Flatten to one dict row for CSV/JSON output."""
        return {
            "round": self.round_id,
            "train_dispatch_s": self.train_dispatch_s,
            "train_round_s": self.train_round_s,
            "aggregation_s": self.aggregation_s,
            "eval_dispatch_s": self.eval_dispatch_s,
            "eval_round_s": self.eval_round_s,
            "federation_round_s": self.federation_round_s,
        }


# ---------------------------------------------------------------------------
# Typed events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dispatched:
    """A TrainTask left for a learner (RunTask fire-and-forget)."""

    round_id: int
    learner_id: str
    task: TrainTask


@dataclasses.dataclass(frozen=True)
class UploadArrived:
    """A learner's completed LocalUpdate arrived off the measured uplink.

    ``error`` carries a learner-side exception instead of an update; the
    engine loop re-raises it on the caller's thread.
    """

    update: LocalUpdate | None
    error: BaseException | None = None

    @property
    def learner_id(self) -> str | None:
        """The arriving learner (None for a failed task with no update)."""
        return self.update.learner_id if self.update is not None else None


@dataclasses.dataclass(frozen=True)
class UploadRejected:
    """Admission control refused an arrived upload (it never reached a store)."""

    round_id: int
    learner_id: str
    reason: str
    norm: float


@dataclasses.dataclass(frozen=True)
class UploadClipped:
    """Admission control norm-clipped an outlier upload before ingest."""

    round_id: int
    learner_id: str
    norm: float
    limit: float


@dataclasses.dataclass(frozen=True)
class LearnerQuarantined:
    """A repeat offender crossed the quarantine threshold."""

    round_id: int
    learner_id: str
    score: float


@dataclasses.dataclass(frozen=True)
class AggregateFired:
    """The policy decided to aggregate (cohort complete)."""

    round_id: int
    n_arrived: int
    trigger: str | None = None


@dataclasses.dataclass(frozen=True)
class Evaluated:
    """The post-aggregation eval fan-out reduced its reports."""

    round_id: int
    metrics: dict


@dataclasses.dataclass(frozen=True)
class EngineStopped:
    """A ``run()`` call ended — the journal's flush-on-stop marker."""

    completed: int
    error: str | None = None


@dataclasses.dataclass
class _RoundState:
    """Book-keeping for the in-flight round (cohort, arrivals, timings)."""

    round_id: int
    cohort: list[str]
    timings: RoundTimings
    t_round: float  # round start (includes cohort selection)
    t_train: float = 0.0  # dispatch start (the T1 mark train_round_s runs from)
    arrived: int = 0
    # Cohort members whose upload landed (aggregation iterates `cohort`, so
    # stack-mode reduces stay in dispatch order); `dropped` holds members
    # that can no longer arrive — the quorum shrinks to match.
    arrived_ids: set = dataclasses.field(default_factory=set)
    dropped: set = dataclasses.field(default_factory=set)
    aggregated: bool = False


def reduce_eval(reports: list[EvalReport]) -> dict:
    """Example-weighted mean of per-learner eval metrics."""
    if not reports:
        return {}
    keys = reports[0].metrics.keys()
    total = sum(r.num_examples for r in reports)
    return {
        k: sum(r.metrics[k] * r.num_examples for r in reports) / max(total, 1)
        for k in keys
    }


class RoundEngine:
    """One arrival-driven loop driving round-based federation workflows.

    ``run(rounds=N)`` drives the sync policy.  :meth:`post` is the only
    entry point for worker threads; every event is processed on the thread
    inside :meth:`run`.  ``event_log`` (bounded) keeps the typed events in
    processing order; ``journal`` their serialized form.
    """

    def __init__(
        self,
        controller: "Controller",
        max_dispatch_workers: int = 32,
        journal: EventJournal | None = None,
    ):
        self.controller = controller
        self._executor = ThreadPoolExecutor(max_workers=max_dispatch_workers)
        self._events: queue.Queue = queue.Queue()
        self.event_log: collections.deque = collections.deque(maxlen=4096)
        self.journal = journal if journal is not None else EventJournal()
        self.telemetry: Telemetry = getattr(controller, "telemetry", None) or Telemetry()
        self._h_round_s = self.telemetry.histogram("engine.round_s")
        self._h_aggregate_s = self.telemetry.histogram("engine.aggregate_s")
        self._g_round = self.telemetry.gauge("engine.round_id")
        self._c_orphaned = self.telemetry.counter("engine.uploads.orphaned")
        self.aggregates_fired = 0  # lifetime AggregateFired count
        self._outstanding = 0  # dispatched-but-not-arrived tasks (loop thread only)
        # Loop-thread mirror of channel.upload_bytes, advanced as arrivals are
        # processed, so aggregate records carry a deterministic uplink total.
        self._up_bytes_seen = 0

    # -- event plumbing -----------------------------------------------------
    def post(self, event: Any) -> None:
        """Thread-safe: enqueue an event for the engine loop (arrival order)."""
        self._events.put(event)

    def _log(self, event: Any, **context: Any) -> None:
        self.event_log.append(event)
        self.journal.record(event, **context)

    # -- dispatch -----------------------------------------------------------
    def _submit(self, lid: str, task: TrainTask, envelope: Any) -> None:
        """Fire-and-forget one task: recv + fit on a worker, post the arrival."""
        c = self.controller
        # Captured now: a learner deregistered while its task is in flight
        # still finishes and its arrival takes the orphaned-upload path.
        learner = c._learners[lid]

        def work() -> None:
            try:
                params = c.channel.recv(envelope)
                update = learner.fit(params, task)
                self.post(UploadArrived(update=update))
            except BaseException as exc:  # surfaced on the loop thread
                self.post(UploadArrived(update=None, error=exc))

        self._executor.submit(work)
        self._outstanding += 1

    def _dispatch_one(self, lid: str, broadcast: Any) -> TrainTask:
        """Size and dispatch one learner's task."""
        c = self.controller
        c._learner_versions[lid] = c._model_version
        task = c.protocol.size_task(
            c.round_id, c._learner_profiles[lid], wire_s=c.wire_time_s(lid)
        )
        envelope = broadcast.to({"task": task, "learner_id": lid})
        self._submit(lid, task, envelope)
        self._log(
            Dispatched(round_id=c.round_id, learner_id=lid, task=task),
            model_version=c._model_version,
            down_bytes=int(envelope.buffer.nbytes),
        )
        return task

    def _start_round(self) -> _RoundState:
        """Select the cohort and fan its tasks out (paper T1-T3)."""
        c = self.controller
        state = _RoundState(
            round_id=c.round_id,
            cohort=[],
            timings=RoundTimings(round_id=c.round_id),
            t_round=time.perf_counter(),
        )
        # Quarantined repeat offenders sit out cohort selection; fail-open if
        # every learner is quarantined.
        available = c.learner_ids
        eligible = [lid for lid in available if not c.is_quarantined(lid)]
        if eligible:
            available = eligible
        kwargs: dict[str, Any] = {}
        if getattr(c.protocol, "needs_profiles", False):
            kwargs["profiles"] = c._learner_profiles
            kwargs["wire_s"] = {lid: c.wire_time_s(lid) for lid in available}
        state.cohort = c.protocol.select_cohort(
            c.selection,
            available,
            c.round_id,
            {lid: c._learners[lid].num_examples for lid in available},
            **kwargs,
        )
        if not state.cohort:
            raise RuntimeError("no learners selected for dispatch")
        state.t_train = time.perf_counter()
        broadcast = c._broadcast()
        for lid in state.cohort:
            self._dispatch_one(lid, broadcast)
        state.timings.train_dispatch_s = time.perf_counter() - state.t_train
        return state

    # -- evaluation ---------------------------------------------------------
    def _evaluate(self, state: _RoundState) -> None:
        """Synchronous EvaluateModel fan-out (paper Fig. 10, T7-T9)."""
        c = self.controller
        t0 = time.perf_counter()
        broadcast = c._broadcast()
        futures = []
        for lid in [x for x in state.cohort if x in c._learners]:
            envelope = broadcast.to({"eval": True})

            def run(lid=lid, envelope=envelope) -> EvalReport:
                params = c.channel.recv(envelope)
                return c._learners[lid].evaluate(params, c.round_id)

            futures.append(self._executor.submit(run))
        state.timings.eval_dispatch_s = time.perf_counter() - t0
        reports = [f.result() for f in futures]
        state.timings.eval_round_s = time.perf_counter() - t0
        state.timings.metrics = reduce_eval(reports)
        self._log(Evaluated(round_id=state.round_id, metrics=state.timings.metrics))

    # -- the loop -----------------------------------------------------------
    def run(self, rounds: int | None = None) -> list[RoundTimings]:
        """Drive ``rounds`` federation rounds; one :class:`RoundTimings` each."""
        c = self.controller
        if c.global_params is None:
            raise RuntimeError("set_initial_model() before running rounds")
        if getattr(c.protocol, "continuous", False):
            raise NotImplementedError(
                "continuous (async) policies are slice B of the port (ROADMAP.md)"
            )
        if rounds is None:
            raise TypeError("round-based policies need rounds=")
        target = int(rounds)
        if target <= 0:
            return []

        out: list[RoundTimings] = []
        completed = 0
        state: _RoundState | None = None

        def fire_round(trigger: str | None, partial: bool = False) -> None:
            # Round aggregate: reduce what arrived, evaluate, advance the round.
            nonlocal state, completed
            ctx: dict[str, Any] = dict(
                weighting=c.protocol.weighting(),
                model_version=c._model_version,
                bytes_down=self.telemetry.value("channel.bytes_moved"),
                bytes_up=self._up_bytes_seen,
            )
            if partial:
                ctx["partial"] = True
            self._log(
                AggregateFired(round_id=state.round_id, n_arrived=state.arrived,
                               trigger=trigger),
                **ctx,
            )
            self.aggregates_fired += 1
            state.timings.train_round_s = time.perf_counter() - state.t_train
            state.timings.aggregation_s = self._aggregate(state)
            state.aggregated = True
            self._evaluate(state)
            state.timings.federation_round_s = time.perf_counter() - state.t_round
            out.append(state.timings)
            c.history.append(state.timings)
            c.round_id += 1
            completed += 1
            self._observe_round(state.timings)
            if completed < target:
                state = self._start_round()

        def check_round_progress(trigger: str | None) -> None:
            # Quorum check after any arrival / dropout: the effective cohort
            # excludes members that can no longer deliver.
            if state.aggregated:
                return
            effective = len(state.cohort) - len(state.dropped)
            if effective <= 0:
                if state.arrived > 0:
                    fire_round(trigger, partial=True)
                elif self._outstanding == 0 and self._events.empty():
                    raise RuntimeError("every learner in the cohort dropped out mid-round")
                return
            if c.protocol.should_aggregate(state.arrived, effective):
                fire_round(trigger)

        def drop(lid: str) -> None:
            if not state.aggregated:
                if lid in state.cohort and lid not in state.arrived_ids:
                    state.dropped.add(lid)
                check_round_progress(lid)

        def handle_upload(event: UploadArrived) -> None:
            self._outstanding -= 1
            if event.error is not None:
                self._log(event)
                raise event.error
            lid = event.learner_id
            up = event.update.upload
            fault = up.metadata.get("fault") if up is not None else None
            if fault is not None:
                # Never ingest a lost or duplicated upload as if it were ok.
                raise NotImplementedError(
                    f"the {fault!r} upload fate is not ported yet: enacting "
                    "transport fault fates is slice B of the port (ROADMAP.md)"
                )
            staleness = c._model_version - c._learner_versions.get(lid, 0)
            up_bytes = int(up.payload.nbytes) if up is not None else None
            if up_bytes is not None:
                self._up_bytes_seen += up_bytes
            if lid not in c._learners:
                # Orphaned: the learner deregistered while its task was in
                # flight.  Tolerated and counted, never fatal.
                self._c_orphaned.add(1)
                self._log(event, staleness=staleness, up_bytes=up_bytes, orphaned=True)
                prof = c._learner_profiles.get(lid)
                if prof is not None:
                    prof.observe_contribution(0.0)
                drop(lid)
                return
            self._log(event, staleness=staleness, up_bytes=up_bytes)
            try:
                if up is None:
                    # Envelope-less update: ingest runs the measured upload
                    # half itself, on this thread — mirror its bytes.
                    before = self.telemetry.value("channel.upload_bytes")
                    clip = c.ingest(event.update)
                    self._up_bytes_seen += int(
                        self.telemetry.value("channel.upload_bytes") - before
                    )
                else:
                    clip = c.ingest(event.update)
            except UploadRejectedError as rej:
                # Nothing was stored: the quorum shrinks, the learner takes
                # the full reputation penalty and an offense mark.
                self._log(
                    UploadRejected(
                        round_id=int(event.update.round_id), learner_id=lid,
                        reason=rej.reason, norm=float(rej.norm),
                    ),
                )
                prof = c._learner_profiles.get(lid)
                if prof is not None:
                    prof.observe_contribution(0.0)
                self._note_offense(lid)
                drop(lid)
                return
            if clip is not None:
                # Ingested rescaled: half reputation credit, an offense mark.
                self._log(
                    UploadClipped(
                        round_id=int(event.update.round_id), learner_id=lid,
                        norm=float(clip["norm"]), limit=float(clip["limit"]),
                    ),
                )
                self._note_offense(lid)
            prof = c._learner_profiles.get(lid)
            if prof is not None:
                prof.observe_contribution(0.5 if clip is not None else 1.0)
            if lid in state.cohort and lid not in state.arrived_ids:
                state.arrived_ids.add(lid)
                state.arrived += 1
            check_round_progress(lid)

        try:
            state = self._start_round()
            # Terminates when the target is met AND nothing is in flight.
            while completed < target or self._outstanding > 0 or not self._events.empty():
                event = self._events.get()
                if isinstance(event, UploadArrived):
                    handle_upload(event)
                else:  # externally posted / unknown events: logged, not fatal
                    self._log(event)
        except BaseException as exc:
            self._abort()
            self._log(EngineStopped(completed=completed, error=repr(exc)))
            raise
        self._log(EngineStopped(completed=completed))
        return out

    def _note_offense(self, lid: str) -> None:
        """Record one admission offense; journal a quarantine entry if it
        tipped the learner's decaying score over the threshold."""
        c = self.controller
        if c.note_offense(lid):
            self._log(
                LearnerQuarantined(
                    round_id=int(c.round_id), learner_id=lid,
                    score=float(c.offense_score(lid)),
                )
            )

    def _observe_round(self, timings: RoundTimings) -> None:
        """Fold one completed round into the engine's telemetry instruments."""
        self._h_round_s.observe(timings.federation_round_s)
        self._h_aggregate_s.observe(timings.aggregation_s)
        self._g_round.set(self.controller.round_id)

    def _aggregate(self, state: _RoundState) -> float:
        """Cohort FedAvg over the members that arrived; returns the seconds."""
        live = [lid for lid in state.cohort if lid in state.arrived_ids]
        return self.controller.aggregate_round(live)

    def _abort(self) -> None:
        """Leave the engine re-runnable after an error escapes the loop:
        wait for every in-flight task, then discard what is queued."""
        while self._outstanding > 0:
            ev = self._events.get()
            if isinstance(ev, UploadArrived):
                self._outstanding -= 1
        while not self._events.empty():
            self._events.get_nowait()

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self) -> None:
        """Stop the dispatch executor (waits for in-flight tasks) and close
        the journal."""
        self._executor.shutdown(wait=True)
        self.journal.close()
