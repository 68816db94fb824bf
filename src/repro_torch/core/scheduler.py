"""Federation protocols as pluggable policies for the round engine.

The port of ``repro/core/scheduler.py``: the task, the EWMA learner
profile, the policy interface and the six protocols, plain Python copied
from the reference.  A protocol is a **policy object** the round engine
(``core/engine.py``) consults at four decision points —
:meth:`ProtocolPolicy.select_cohort`, :meth:`~ProtocolPolicy.size_task`,
:meth:`~ProtocolPolicy.should_aggregate` and :meth:`~ProtocolPolicy.weighting`.

* **synchronous** (:class:`SyncProtocol`) — the same step budget for every
  selected learner; aggregate when *all* uploads arrived (FedAvg);
* **semi-synchronous** (:class:`SemiSyncProtocol`) — a wall-clock
  hyper-period; each learner's steps come from its measured seconds per step
  minus its modeled round-trip wire time;
* **asynchronous** (:class:`AsyncProtocol`) — a staleness-damped community
  update on *every* arrival, no round barrier;
* **buffered asynchronous** (:class:`BufferedAsyncProtocol`, FedBuff) — one
  staleness-damped update over every ``buffer_k`` buffered arrivals;
* **deadline cohorts** (:class:`DeadlineCohortProtocol`) — dispatch only the
  learners predicted to finish inside ``deadline_s``; an optional wall-clock
  timer aggregates what arrived and carries stragglers to the next round;
* **reputation** (:class:`ReputationProtocol`) — the top ``fraction`` of the
  selection ranked by each learner's contribution EWMA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.selection import SelectionPolicy, select_learners

__all__ = [
    "TrainTask",
    "LearnerProfile",
    "ProtocolPolicy",
    "SyncProtocol",
    "SemiSyncProtocol",
    "AsyncProtocol",
    "BufferedAsyncProtocol",
    "DeadlineCohortProtocol",
    "ReputationProtocol",
]


@dataclasses.dataclass(frozen=True)
class TrainTask:
    """The unit the controller dispatches to a learner (paper's RunTask)."""

    round_id: int
    local_steps: int
    batch_size: int
    learning_rate: float
    # FedProx proximal coefficient; 0 disables the proximal term.
    prox_mu: float = 0.0
    metadata: dict = dataclasses.field(default_factory=dict)


class LearnerProfile(dict):
    """Per-learner execution profile with an EWMA seconds-per-step estimate.

    A plain ``dict`` (``profile["seconds_per_step"]``) whose step time is an
    exponentially weighted moving average,
    ``est_new = decay * est_old + (1 - decay) * observation``
    (``decay=0`` keeps the last sample).  ``upload_bytes`` records the
    learner's latest wire payload size; ``reputation`` an EWMA of its
    contributions.
    """

    def __init__(self, decay: float = 0.5):
        super().__init__()
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.decay = float(decay)
        self.observations = 0
        self.rep_observations = 0

    def observe_step_time(self, seconds_per_step: float) -> float:
        """Fold one measured seconds-per-step sample into the EWMA."""
        obs = float(seconds_per_step)
        if self.observations == 0:
            est = obs
        else:
            est = self.decay * float(self["seconds_per_step"]) + (1.0 - self.decay) * obs
        self["seconds_per_step"] = est
        self.observations += 1
        return est

    def observe_upload_bytes(self, nbytes: int) -> None:
        """Record the learner's latest measured uplink payload size."""
        self["upload_bytes"] = int(nbytes)

    def observe_contribution(self, score: float) -> float:
        """Fold one contribution observation (1.0 useful, 0.0 lost) into the
        reputation EWMA, tracked under its own observation counter."""
        obs = float(score)
        if self.rep_observations == 0:
            est = obs
        else:
            est = self.decay * float(self["reputation"]) + (1.0 - self.decay) * obs
        self["reputation"] = est
        self.rep_observations += 1
        return est

    def reputation(self, default: float = 1.0) -> float:
        """Current reputation estimate (``default`` when never observed)."""
        return float(self.get("reputation", default))

    def decay_reputation(self, rounds_absent: int, rate: float = 0.9) -> float:
        """Multiplicatively decay reputation over ``rounds_absent`` rounds."""
        rounds_absent = int(rounds_absent)
        if rounds_absent > 0 and "reputation" in self:
            self["reputation"] = float(self["reputation"]) * float(rate) ** rounds_absent
        return self.reputation()


class ProtocolPolicy:
    """The pluggable policy interface the round engine drives protocols by.

    The defaults implement round-based (synchronous-family) behaviour.
    """

    #: Round-based policies (False) barrier on a cohort and evaluate after
    #: each aggregate; continuous policies (True) aggregate per arrival and
    #: immediately re-dispatch the arriving learner.
    continuous: bool = False

    #: Policies that rank or predict from learner state set this True; the
    #: engine then passes ``profiles=``/``wire_s=`` to :meth:`select_cohort`.
    needs_profiles: bool = False

    def select_cohort(
        self,
        selection: SelectionPolicy,
        learner_ids: Sequence[str],
        round_id: int,
        num_examples: dict[str, int] | None = None,
    ) -> list[str]:
        """Pick this round's cohort (defaults to the selection policy)."""
        return select_learners(selection, list(learner_ids), round_id, num_examples)

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Size one learner's task; ``wire_s`` is its modeled round-trip wire time."""
        raise TypeError(f"{type(self).__name__} must define size_task")

    def should_aggregate(self, arrived: int, cohort_size: int) -> bool:
        """True when the engine should fire an aggregation event."""
        return arrived >= cohort_size

    def weighting(self) -> str:
        """Arena row weighting at the reduce: ``"fedavg"`` or ``"staleness"``."""
        return "fedavg"

    def make_task(self, round_id: int, learner_profile: dict | None = None) -> TrainTask:
        """Legacy alias for :meth:`size_task` with no wire-time input."""
        return self.size_task(round_id, learner_profile)


@dataclasses.dataclass(frozen=True)
class SyncProtocol(ProtocolPolicy):
    """Synchronous rounds: same step budget for every selected learner,
    aggregate when the whole cohort has uploaded (paper's FedAvg setting)."""

    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    prox_mu: float = 0.0

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Build the fixed-step TrainTask for this round."""
        return TrainTask(
            round_id=round_id,
            local_steps=self.local_steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
        )


@dataclasses.dataclass(frozen=True)
class SemiSyncProtocol(ProtocolPolicy):
    """Fixed hyper-period: per-learner step count derived from measured speed.

    ``hyperperiod_s`` is the wall-clock budget per round.  The controller
    keeps an EWMA estimate of each learner's seconds-per-step
    (:class:`LearnerProfile`) and the policy assigns

    ``steps_i = max(1, floor((hyperperiod_s - wire_i) / spstep_i))``

    where ``wire_i`` is learner *i*'s modeled round-trip wire time (downlink
    broadcast + uplink upload, from the channel's bandwidth/latency model —
    see ``Controller.wire_time_s``).  Subtracting it makes the budget cover
    *train + wire*: under a bandwidth cap a naively sized task would finish
    training exactly at the hyper-period and then blow the budget by the
    upload time.  ``wire_aware=False`` keeps the legacy train-only sizing
    (the ``benchmarks/bench_round.py --schedule`` comparison arm).
    """

    hyperperiod_s: float = 1.0
    batch_size: int = 100
    learning_rate: float = 0.01
    default_steps: int = 1
    prox_mu: float = 0.0
    wire_aware: bool = True

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Size the task from measured seconds-per-step minus wire time."""
        steps = self.default_steps
        sps = (learner_profile or {}).get("seconds_per_step", 0)
        if sps and sps > 0:
            budget = self.hyperperiod_s - (wire_s if self.wire_aware else 0.0)
            steps = max(1, int(budget / sps))
        return TrainTask(
            round_id=round_id,
            local_steps=steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
            metadata={"semi_sync": True, "wire_s": wire_s},
        )


@dataclasses.dataclass(frozen=True)
class AsyncProtocol(ProtocolPolicy):
    """Asynchronous policy: no round barrier — the engine aggregates on every
    arrival, staleness-damped by ``staleness_alpha``
    (``core/aggregation.staleness_weights``; semantics in docs/PROTOCOLS.md),
    and immediately re-dispatches the arriving learner."""

    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    staleness_alpha: float = 0.5
    prox_mu: float = 0.0
    continuous = True

    def select_cohort(
        self,
        selection: SelectionPolicy,
        learner_ids: Sequence[str],
        round_id: int,
        num_examples: dict[str, int] | None = None,
    ) -> list[str]:
        """Every registered learner participates (no per-round cohort)."""
        return list(learner_ids)

    def should_aggregate(self, arrived: int, cohort_size: int) -> bool:
        """Every arrival triggers a community update."""
        return arrived >= 1

    def weighting(self) -> str:
        """Rows are example-count weights damped by staleness."""
        return "staleness"

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Build the TrainTask for the learner's next async leg."""
        return TrainTask(
            round_id=round_id,
            local_steps=self.local_steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
            metadata={"async": True},
        )


@dataclasses.dataclass(frozen=True)
class BufferedAsyncProtocol(ProtocolPolicy):
    """FedBuff-style buffered asynchrony: aggregate every K arrivals.

    Like :class:`AsyncProtocol` there is no round barrier — every learner is
    always training and is re-dispatched after contributing — but instead of
    a community update per arrival, the engine buffers arrivals and fires one
    staleness-weighted aggregate over exactly the buffered members once the
    buffer holds ``buffer_k`` of them (``aggregate_scope = "buffer"`` routes
    the engine to ``Controller.aggregate_buffer``).  With fewer than
    ``buffer_k`` registered learners the threshold clamps to the live fleet
    size so shrinking (churned) federations keep making progress.
    """

    buffer_k: int = 8
    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    staleness_alpha: float = 0.5
    prox_mu: float = 0.0
    continuous = True
    #: Aggregate over the buffered members only, not every valid arena row.
    aggregate_scope = "buffer"

    def select_cohort(
        self,
        selection: SelectionPolicy,
        learner_ids: Sequence[str],
        round_id: int,
        num_examples: dict[str, int] | None = None,
    ) -> list[str]:
        """Every registered learner trains concurrently (no cohort)."""
        return list(learner_ids)

    def should_aggregate(self, arrived: int, cohort_size: int) -> bool:
        """Fire once the buffer holds K arrivals (clamped to the fleet size)."""
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        return arrived >= max(1, min(self.buffer_k, cohort_size))

    def weighting(self) -> str:
        """Buffered rows are example-count weights damped by staleness."""
        return "staleness"

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Build the TrainTask for the learner's next buffered-async leg."""
        return TrainTask(
            round_id=round_id,
            local_steps=self.local_steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
            metadata={"buffered_async": True, "buffer_k": self.buffer_k},
        )


@dataclasses.dataclass(frozen=True)
class DeadlineCohortProtocol(ProtocolPolicy):
    """Deadline-predicted cohorts: dispatch only learners expected on time.

    A round-based policy that forms each cohort from the learners whose
    predicted completion time — EWMA seconds-per-step × ``local_steps`` plus
    the modeled round-trip wire time — lands inside ``deadline_s``.
    Unprofiled learners are optimistically assumed on time; if *nobody*
    qualifies the single fastest-predicted learner is dispatched so the
    federation never stalls.  With ``enforce_wall_clock=True`` the engine
    additionally arms a wall-clock timer per round and, at the deadline,
    aggregates whatever has arrived; stragglers land as *late* uploads that
    are folded into the next round's aggregate
    (``engine.faults.uploads_late``).  Harnesses that need byte-identical
    journals set ``enforce_wall_clock=False`` (prediction only — no timers).
    """

    deadline_s: float = 1.0
    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    prox_mu: float = 0.0
    enforce_wall_clock: bool = True
    needs_profiles = True

    def select_cohort(
        self,
        selection: SelectionPolicy,
        learner_ids: Sequence[str],
        round_id: int,
        num_examples: dict[str, int] | None = None,
        profiles: Mapping[str, Mapping] | None = None,
        wire_s: Mapping[str, float] | None = None,
    ) -> list[str]:
        """Keep the base selection's learners predicted to beat the deadline."""
        base = select_learners(selection, list(learner_ids), round_id, num_examples)
        profiles = profiles or {}
        wire_s = wire_s or {}
        on_time: list[str] = []
        predicted: list[tuple[float, str]] = []
        for lid in base:
            sps = (profiles.get(lid) or {}).get("seconds_per_step", 0.0)
            eta = float(wire_s.get(lid, 0.0))
            if sps and sps > 0:
                eta += self.local_steps * float(sps)
            else:
                eta = 0.0  # unprofiled: optimistically on time
            predicted.append((eta, lid))
            if eta <= self.deadline_s:
                on_time.append(lid)
        if on_time:
            return on_time
        # Never stall: take the single fastest-predicted learner (ties break
        # lexicographically, keeping cohort formation deterministic).
        return [min(predicted)[1]] if predicted else []

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Build the fixed-step TrainTask carrying the round deadline."""
        return TrainTask(
            round_id=round_id,
            local_steps=self.local_steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
            metadata={"deadline_s": self.deadline_s},
        )


@dataclasses.dataclass(frozen=True)
class ReputationProtocol(ProtocolPolicy):
    """Reputation-weighted selection: dispatch the highest-contributing slice.

    Round-based FedAvg whose cohort is the top ``fraction`` of the base
    selection ranked by the :class:`LearnerProfile` reputation EWMA
    (contributions observed by the controller: 1.0 per useful upload, 0.0
    per lost/orphaned one, multiplicative decay over dropout absences).
    Unobserved learners rank at the default reputation 1.0 — new joiners are
    not starved — and the sort is stable, so equal reputations preserve the
    base selection order (``fraction=1.0`` degenerates to plain sync).
    ``min_learners`` floors the cohort so aggregation always has quorum.
    """

    fraction: float = 0.5
    min_learners: int = 1
    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    prox_mu: float = 0.0
    needs_profiles = True

    def select_cohort(
        self,
        selection: SelectionPolicy,
        learner_ids: Sequence[str],
        round_id: int,
        num_examples: dict[str, int] | None = None,
        profiles: Mapping[str, Mapping] | None = None,
        wire_s: Mapping[str, float] | None = None,
    ) -> list[str]:
        """Stable-rank the base selection by reputation, keep the top slice."""
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        base = select_learners(selection, list(learner_ids), round_id, num_examples)
        profiles = profiles or {}

        def _rep(lid: str) -> float:
            prof = profiles.get(lid)
            if prof is None:
                return 1.0
            rep = getattr(prof, "reputation", None)
            if callable(rep):
                return float(rep())
            return float(prof.get("reputation", 1.0))

        ranked = sorted(base, key=lambda lid: -_rep(lid))
        if not ranked:
            return ranked
        k = max(int(self.min_learners), math.ceil(self.fraction * len(ranked)))
        return ranked[: min(len(ranked), max(1, k))]

    def size_task(
        self, round_id: int, learner_profile: dict | None = None, wire_s: float = 0.0
    ) -> TrainTask:
        """Build the fixed-step TrainTask for the selected learner."""
        return TrainTask(
            round_id=round_id,
            local_steps=self.local_steps,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            prox_mu=self.prox_mu,
            metadata={"reputation": True},
        )
