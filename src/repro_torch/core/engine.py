"""The event-driven round engine: one arrival-driven loop for every protocol.

The port of ``repro/core/engine.py``.  :meth:`RoundEngine.run` consumes
**typed events** and delegates every protocol decision to the
:class:`~repro_torch.core.scheduler.ProtocolPolicy` hooks; the controller is
model-state + transport + store plumbing (``core/controller.py``); the engine
owns the dispatch executor and the control flow.

Event grammar (one loop, six workflows):

* :class:`Dispatched` — a task left the controller for a learner;
* :class:`UploadArrived` — a learner's ``LocalUpdate`` came off the measured
  uplink, posted from an executor thread through :meth:`RoundEngine.post`;
  the loop ingests it and asks ``policy.should_aggregate``;
* :class:`AggregateFired` — the policy said aggregate: the cohort FedAvg for
  round-based policies, a staleness-damped community update for the
  continuous ones (over exactly the buffered ``members`` under FedBuff);
* :class:`DeadlineExpired` — a deadline-cohort round's wall-clock timer
  elapsed: the loop aggregates what arrived, stragglers fold into the next
  round as late uploads;
* :class:`Evaluated` — the post-aggregation eval fan-out reduced its reports
  (round-based policies only).

The loop is the only consumer of the queue, so all state mutation is
serialized without protocol code touching a lock.  Learner work runs on a
``ThreadPoolExecutor``; CUDA work issued from those threads goes to the
default stream, which keeps it correct.  The transport fault fates stamped
by ``core/faults.FaultyChannel`` are enacted here: a ``lost`` upload is never
ingested (the round's quorum shrinks; a continuous learner gets a retry
leg), a ``dup`` upload is delivered twice, the second copy handled inline.
With ``checkpoint_every=k`` the engine checkpoints the federation every k
completed rounds or community updates, at the boundary and before the next
dispatch, after draining the tasks in flight into engine state without
firing aggregates; a restored controller's engine owes exactly the
dispatches that were about to leave.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Iterator, NamedTuple

from repro_torch.core import tracing
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
    "DeadlineExpired",
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
    #: True for the engine-requeued second delivery of a fault-injected
    #: duplicated upload; duplicates do not consume an outstanding slot.
    duplicate: bool = False
    #: The engine's id of the task that produced the update (its spans').
    task: int | None = None
    #: While a profiler collects: when the worker posted it (``tracing.mark``),
    #: the start of its ``engine.arrival_queue`` span.
    posted: int | None = None

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
    """The policy decided to aggregate (cohort complete / every arrival)."""

    round_id: int
    n_arrived: int
    trigger: str | None = None  # the arriving learner, for continuous re-dispatch
    #: Buffered-async (FedBuff) only: the exact learner ids folded into this
    #: community update (None for round-based / plain-async aggregates).
    members: tuple | None = None


@dataclasses.dataclass(frozen=True)
class DeadlineExpired:
    """A round's wall-clock deadline elapsed (DeadlineCohortProtocol).

    Posted by the per-round timer; the loop fires a *partial* aggregate over
    whatever arrived, and stragglers fold into the next round as late
    uploads.  Ignored (logged only) when the round already aggregated.
    """

    round_id: int


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


class _Submitted(NamedTuple):
    """A task the engine submitted: its id and, while a profiler collects,
    its submit time (``tracing.mark``, the start of its ``dispatch.queue``
    span) and the tasks waiting ahead of it in the executor's queue."""

    task: int
    queued: int | None
    depth: int | None


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
    deadline_timer: Any = None


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


def _without_model(event: Any) -> Any:
    """``event`` as the event log keeps it: an ``UploadArrived`` drops its
    update's params, packed row and wire payload (ingest has read them);
    the learner, round, metrics and envelope metadata stay."""
    if not isinstance(event, UploadArrived) or event.update is None:
        return event
    up = event.update.upload
    update = dataclasses.replace(
        event.update, params=None, buffer=None,
        upload=None if up is None else dataclasses.replace(up, payload=None))
    return dataclasses.replace(event, update=update)


class RoundEngine:
    """One arrival-driven loop driving every federation workflow.

    ``run(rounds=N)`` drives round-based policies (sync, semi-sync, deadline
    cohorts, reputation); ``run(total_updates=N)`` the continuous ones
    (async, FedBuff).  :meth:`post` is the only entry point for worker
    threads; every event is processed on the thread inside :meth:`run`.
    ``event_log`` (bounded) keeps the typed events in processing order, an
    arrival without its model (trained params, packed row, wire payload:
    4,096 fedlm-100m arrivals would pin 1.2 TB); ``journal`` their
    serialized form.
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
        self._c_lost = self.telemetry.counter("engine.faults.uploads_lost")
        self._c_dup = self.telemetry.counter("engine.faults.uploads_duplicated")
        self._c_late = self.telemetry.counter("engine.faults.uploads_late")
        self._c_deadline = self.telemetry.counter("engine.faults.deadline_fires")
        self.aggregates_fired = 0  # lifetime AggregateFired count
        self._outstanding = 0  # dispatched-but-not-arrived tasks (loop thread only)
        # Continuous-policy state that outlives a single run() call (and is
        # checkpointed): the FedBuff arrival buffer, the stragglers owed to
        # the next round-based aggregate, and the dispatch list a restored
        # checkpoint owes its first round.
        self._buffer: list[str] = []
        self._late_carry: list[str] = []
        self._resume_dispatch: list[str] | None = None
        self._pending_dispatch: list[str] | None = None  # set around save_checkpoint
        # Continuous-mode learners whose upload was lost or rejected while a
        # pre-checkpoint drain absorbed arrivals (fire=False, so the usual
        # immediate retry leg must not run): they are owed a re-dispatch once
        # the checkpoint is written, and join the checkpointed pending
        # dispatch list so a restored run owes them too.  Without this they
        # would leave the rotation, and a buffer_k == fleet-size policy could
        # never fill its buffer again.
        self._retry_pending: list[str] = []
        # Loop-thread mirror of channel.upload_bytes, advanced as arrivals are
        # processed, so aggregate records carry a deterministic uplink total.
        self._up_bytes_seen = 0
        self._tasks_submitted = 0  # the next task's id (loop thread only)

    # -- event plumbing -----------------------------------------------------
    def post(self, event: Any) -> None:
        """Thread-safe: enqueue an event for the engine loop (arrival order)."""
        self._events.put(event)

    def _log(self, event: Any, **context: Any) -> None:
        self.event_log.append(_without_model(event))
        self.journal.record(event, **context)

    # -- dispatch -----------------------------------------------------------
    def _new_task(self) -> _Submitted:
        """Number the task about to be submitted (loop thread only)."""
        task = self._tasks_submitted
        self._tasks_submitted += 1
        queued = tracing.mark()
        depth = None if queued is None else self._executor._work_queue.qsize()
        return _Submitted(task, queued, depth)

    @contextlib.contextmanager
    def _running(self, sub: _Submitted, lid: str, task_kind: str) -> Iterator[None]:
        """A task's work on its worker: the spans closed inside carry its id
        and learner, the first, ``dispatch.queue``, its wait for the worker."""
        with tracing.bind(self.journal, task=sub.task, learner=lid):
            tracing.close("dispatch.queue", sub.queued, task_kind=task_kind, depth=sub.depth)
            yield

    def _submit(self, lid: str, task: TrainTask, envelope: Any) -> None:
        """Fire-and-forget one task: recv + fit on a worker, post the arrival."""
        c = self.controller
        # Captured now: a learner deregistered while its task is in flight
        # still finishes and its arrival takes the orphaned-upload path.
        learner = c._learners[lid]
        sub = self._new_task()

        def work() -> None:
            try:
                with self._running(sub, lid, "train"):
                    params = c.channel.recv(envelope)
                    update = learner.fit(params, task)
                self.post(UploadArrived(update=update, task=sub.task, posted=tracing.mark()))
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
        continuous = bool(getattr(c.protocol, "continuous", False))
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
            # Ranking/predicting policies also see the EWMA profiles and each
            # learner's modeled round-trip wire time.
            kwargs["profiles"] = c._learner_profiles
            kwargs["wire_s"] = {lid: c.wire_time_s(lid) for lid in available}
        state.cohort = c.protocol.select_cohort(
            c.selection,
            available,
            c.round_id,
            {lid: c._learners[lid].num_examples for lid in available},
            **kwargs,
        )
        if continuous:
            if self._resume_dispatch is not None:
                # A restored checkpoint owes exactly the dispatches that were
                # about to leave when the state was saved.
                state.cohort = [lid for lid in self._resume_dispatch if lid in c._learners]
                self._resume_dispatch = None
            else:
                # Learners already sitting in the FedBuff buffer have an
                # ingested-but-unaggregated row; re-dispatching them would
                # overwrite it before it is reduced.
                buffered = set(self._buffer)
                state.cohort = [lid for lid in state.cohort if lid not in buffered]
        if not state.cohort and not self._buffer:
            raise RuntimeError("no learners selected for dispatch")
        state.t_train = time.perf_counter()
        broadcast = c._broadcast() if state.cohort else None
        for lid in state.cohort:
            self._dispatch_one(lid, broadcast)
        state.timings.train_dispatch_s = time.perf_counter() - state.t_train
        deadline = getattr(c.protocol, "deadline_s", None)
        if (not continuous and deadline is not None
                and getattr(c.protocol, "enforce_wall_clock", False)):
            timer = threading.Timer(
                float(deadline),
                lambda rid=state.round_id: self.post(DeadlineExpired(round_id=rid)),
            )
            timer.daemon = True
            timer.start()
            state.deadline_timer = timer
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
            sub = self._new_task()

            def run(lid=lid, envelope=envelope, sub=sub) -> EvalReport:
                with self._running(sub, lid, "eval"):
                    params = c.channel.recv(envelope)
                    with tracing.Span("learner.eval"):
                        return c._learners[lid].evaluate(params, c.round_id)

            futures.append(self._executor.submit(run))
        state.timings.eval_dispatch_s = time.perf_counter() - t0
        reports = [f.result() for f in futures]
        state.timings.eval_round_s = time.perf_counter() - t0
        state.timings.metrics = reduce_eval(reports)
        self._log(Evaluated(round_id=state.round_id, metrics=state.timings.metrics))

    # -- the loop -----------------------------------------------------------
    def run(
        self,
        rounds: int | None = None,
        total_updates: int | None = None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None,
    ) -> list[RoundTimings]:
        """Drive the federation: ``rounds=`` for round-based policies,
        ``total_updates=`` for the continuous ones.

        Returns one :class:`RoundTimings` per completed round / community
        update (continuous runs may append a few extra entries: tasks still
        in flight when the target is reached are drained and, as the paper's
        per-arrival semantics say, still aggregated).

        ``checkpoint_every=k`` persists the federation state
        (``Controller.save_checkpoint``) every k completed rounds or updates,
        before the next dispatch, so a killed run restores at a boundary and
        replays forward bit-identically.  Both knobs default to the
        controller's ``checkpoint_every``/``checkpoint_dir``.
        """
        c = self.controller
        if c.global_params is None:
            raise RuntimeError("set_initial_model() before running rounds")
        if checkpoint_every is None:
            checkpoint_every = getattr(c, "checkpoint_every", None)
        if checkpoint_dir is None:
            checkpoint_dir = getattr(c, "checkpoint_dir", None)
        ckpt_every = int(checkpoint_every or 0)
        continuous = bool(getattr(c.protocol, "continuous", False))
        if continuous:
            if total_updates is None:
                raise TypeError("continuous (async) policies need total_updates=")
            target = int(total_updates)
        else:
            if rounds is None:
                raise TypeError("round-based policies need rounds=")
            if total_updates is not None:
                raise TypeError("total_updates= requires a continuous (async) policy")
            target = int(rounds)
        if target <= 0:
            return []

        out: list[RoundTimings] = []
        completed = 0
        state: _RoundState | None = None

        def drain_outstanding() -> None:
            # Absorb every in-flight arrival into engine state (buffer,
            # arrived set, late carry) without firing aggregates, so the
            # state a checkpoint writes is quiescent.
            while self._outstanding > 0:
                ev = self._events.get()
                if isinstance(ev, UploadArrived):
                    handle_upload(ev, fire=False)
                else:
                    self._log(ev)

        def maybe_checkpoint(pending: list[str] | None = None) -> None:
            # At a boundary, before the next dispatch: the saved state has no
            # partial-round arrivals to reconcile on restore.
            if ckpt_every and checkpoint_dir and c.round_id % ckpt_every == 0:
                drain_outstanding()
                pend = list(pending) if pending is not None else None
                if self._retry_pending:
                    # Learners whose upload the drain lost are owed their
                    # retry leg alongside the buffer members.
                    pend = pend if pend is not None else []
                    pend += [x for x in self._retry_pending if x not in pend]
                self._pending_dispatch = pend
                try:
                    c.save_checkpoint(checkpoint_dir)
                finally:
                    self._pending_dispatch = None

        def fire_round(trigger: str | None, partial: bool = False) -> None:
            # Round-based aggregate: reduce what arrived (plus carried-over
            # stragglers), evaluate, advance the round.
            nonlocal state, completed
            if state.deadline_timer is not None:
                state.deadline_timer.cancel()
                state.deadline_timer = None
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
            maybe_checkpoint()
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

        def pump_continuous() -> None:
            # Fire while the buffer satisfies the policy.  Plain async keeps
            # its aggregate-per-arrival semantics (a buffer of 1); FedBuff
            # drains K members into one staleness-weighted update.
            nonlocal completed
            while self._buffer and c.protocol.should_aggregate(
                len(self._buffer), max(1, len(c._learners))
            ):
                members = tuple(self._buffer)
                self._buffer.clear()
                self._log(
                    AggregateFired(round_id=state.round_id, n_arrived=len(members),
                                   trigger=members[-1], members=members),
                    weighting=c.protocol.weighting(),
                    model_version=c._model_version,
                    bytes_down=self.telemetry.value("channel.bytes_moved"),
                    bytes_up=self._up_bytes_seen,
                )
                self.aggregates_fired += 1
                timings = RoundTimings(round_id=c.round_id)
                timings.aggregation_s = self._aggregate(state, members)
                timings.federation_round_s = timings.aggregation_s
                out.append(timings)
                c.history.append(timings)
                c.round_id += 1
                completed += 1
                self._observe_round(timings)
                # The members get the fresh model at once (one shared
                # broadcast); checkpointed first, so a restored run owes
                # exactly these dispatches.
                redisp = [lid for lid in members if lid in c._learners]
                maybe_checkpoint(pending=redisp)
                if completed < target:
                    # Learners lost during a drain rejoin the rotation with
                    # the buffer members.
                    redisp += [lid for lid in self._retry_pending
                               if lid in c._learners and lid not in redisp]
                    b = c._broadcast()
                    for lid in redisp:
                        self._dispatch_one(lid, b)
                self._retry_pending = []

        def drop(lid: str, fire: bool) -> None:
            # A round-based cohort member that can no longer deliver.
            if not state.aggregated:
                if lid in state.cohort and lid not in state.arrived_ids:
                    state.dropped.add(lid)
                if fire:
                    check_round_progress(lid)

        def retry_or_drop(lid: str, fire: bool) -> None:
            # Nothing was stored: a continuous learner gets a fresh leg at
            # once (after the checkpoint, when a drain absorbed it); a
            # round-based cohort shrinks its quorum.
            if continuous:
                if fire:
                    if completed < target:
                        self._dispatch_one(lid, c._broadcast())
                elif lid not in self._retry_pending:
                    self._retry_pending.append(lid)
            else:
                drop(lid, fire)

        def handle_upload(event: UploadArrived, fire: bool = True) -> None:
            # Spans closed while the loop handles the arrival (ingest, an
            # aggregate it fires, the broadcast after) carry its task's id.
            with tracing.bind(self.journal, task=event.task, learner=event.learner_id):
                if not event.duplicate:
                    tracing.close("engine.arrival_queue", event.posted)
                handle_arrival(event, fire)

        def handle_arrival(event: UploadArrived, fire: bool) -> None:
            if not event.duplicate:
                self._outstanding -= 1
            if event.error is not None:
                self._log(event)
                raise event.error
            lid = event.learner_id
            up = event.update.upload
            staleness = c._model_version - c._learner_versions.get(lid, 0)
            up_bytes = int(up.payload.nbytes) if up is not None else None
            fault = up.metadata.get("fault") if up is not None else None
            if up_bytes is not None and not event.duplicate:
                # A duplicate delivery re-uses the envelope: one wire send.
                self._up_bytes_seen += up_bytes
            if lid not in c._learners:
                # Orphaned: the learner deregistered while its task was in
                # flight.  Tolerated and counted, never fatal.
                self._c_orphaned.add(1)
                self._log(event, staleness=staleness, up_bytes=up_bytes, orphaned=True)
                prof = c._learner_profiles.get(lid)
                if prof is not None:
                    prof.observe_contribution(0.0)
                if not continuous:
                    drop(lid, fire)
                return
            if fault == "lost":
                # The uplink dropped the payload: nothing to ingest.
                self._c_lost.add(1)
                self._log(event, staleness=staleness, up_bytes=up_bytes, lost=True)
                prof = c._learner_profiles.get(lid)
                if prof is not None:
                    prof.observe_contribution(0.0)
                retry_or_drop(lid, fire)
                return
            ctx: dict[str, Any] = {"staleness": staleness, "up_bytes": up_bytes}
            if event.duplicate:
                ctx["duplicate"] = True
            self._log(event, **ctx)
            try:
                if up is None and not event.duplicate:
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
                # Nothing was stored: the learner takes the full reputation
                # penalty and an offense mark, then retries or drops out.
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
                retry_or_drop(lid, fire)
                return
            if clip is not None and not event.duplicate:
                # Ingested rescaled: half reputation credit, an offense mark.
                self._log(
                    UploadClipped(
                        round_id=int(event.update.round_id), learner_id=lid,
                        norm=float(clip["norm"]), limit=float(clip["limit"]),
                    ),
                )
                self._note_offense(lid)
            if not event.duplicate:
                prof = c._learner_profiles.get(lid)
                if prof is not None:
                    prof.observe_contribution(0.5 if clip is not None else 1.0)
            if fault == "dup" and not event.duplicate:
                # The uplink delivered twice: the second copy is handled
                # inline, right after the first, so journal order never
                # depends on worker timing.  The recursion does this
                # learner's buffer/arrival bookkeeping and may fire an
                # aggregate that advances the round, so this frame must not
                # fall through (a phantom buffer member / spurious late carry).
                self._c_dup.add(1)
                handle_upload(dataclasses.replace(event, duplicate=True), fire=fire)
                return
            if continuous:
                if lid not in self._buffer:
                    self._buffer.append(lid)
                if fire:
                    pump_continuous()
                return
            if int(event.update.round_id) < c.round_id or state.aggregated:
                # Straggler from an already-aggregated round (the deadline
                # fired without it): folded into the next round's reduce.
                self._c_late.add(1)
                if lid not in self._late_carry:
                    self._late_carry.append(lid)
                if fire and not state.aggregated:
                    check_round_progress(lid)  # deadlock check, never a count
                return
            if lid in state.cohort and lid not in state.arrived_ids:
                state.arrived_ids.add(lid)
                state.arrived += 1
            if fire:
                check_round_progress(lid)

        # Spans the loop closes outside an arrival (the first broadcast, a
        # deadline's aggregate) record to the journal with no task.
        with tracing.bind(self.journal):
            try:
                state = self._start_round()
                if continuous:
                    # A buffer carried from an earlier run() or restored from a
                    # checkpoint may already satisfy the policy.
                    pump_continuous()
                # Terminates when the target is met AND nothing is in flight or
                # queued.
                while completed < target or self._outstanding > 0 or not self._events.empty():
                    event = self._events.get()
                    if isinstance(event, UploadArrived):
                        handle_upload(event)
                    elif isinstance(event, DeadlineExpired):
                        if (not continuous and not state.aggregated
                                and event.round_id == state.round_id and state.arrived > 0):
                            self._c_deadline.add(1)
                            self._log(event)
                            fire_round(trigger=None, partial=True)
                        else:  # stale timer (round already aggregated): log only
                            self._log(event)
                    else:  # externally posted / unknown events: logged, not fatal
                        self._log(event)
            except BaseException as exc:
                if state is not None and state.deadline_timer is not None:
                    state.deadline_timer.cancel()
                self._abort()
                self._log(EngineStopped(completed=completed, error=repr(exc)))
                raise
            if state is not None and state.deadline_timer is not None:
                state.deadline_timer.cancel()
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

    def _take_late(self) -> list[str]:
        """Consume the stragglers owed to the next round-based aggregate."""
        late, self._late_carry = self._late_carry, []
        return late

    def _aggregate(self, state: _RoundState, members: tuple | None = None) -> float:
        """Reduce per the policy's weighting hook; returns the seconds.

        ``aggregate_scope == "buffer"`` (FedBuff) reduces exactly the
        buffered ``members``; ``"staleness"`` weighting aggregates every
        valid stored model with staleness-damped weights (the community
        update); anything else is the cohort FedAvg over the members that
        arrived plus any stragglers carried over from a deadline-expired
        round.
        """
        c = self.controller
        if getattr(c.protocol, "aggregate_scope", None) == "buffer":
            return c.aggregate_buffer(list(members or ()))
        if c.protocol.weighting() == "staleness":
            return c.aggregate_community()
        live = [lid for lid in state.cohort if lid in state.arrived_ids]
        seen = set(live)
        extras = [lid for lid in self._take_late() if lid not in seen and lid in c._learners]
        return c.aggregate_round(live + extras)

    def _abort(self) -> None:
        """Leave the engine re-runnable after an error escapes the loop:
        wait for every in-flight task, then discard what is queued (stale
        arrivals or pending duplicate deliveries must not leak into a later
        ``run()``)."""
        while self._outstanding > 0:
            ev = self._events.get()
            if isinstance(ev, UploadArrived) and not ev.duplicate:
                self._outstanding -= 1
        while not self._events.empty():
            self._events.get_nowait()

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self) -> None:
        """Stop the dispatch executor (waits for in-flight tasks) and close
        the journal."""
        self._executor.shutdown(wait=True)
        self.journal.close()
