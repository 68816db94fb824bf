"""Federation protocols as pluggable policies for the round engine.

The port of ``repro/core/scheduler.py`` for the slice: the task, the EWMA
learner profile, the policy interface and the synchronous protocol.  A
protocol is a **policy object** the round engine (``core/engine.py``)
consults at four decision points — :meth:`ProtocolPolicy.select_cohort`,
:meth:`~ProtocolPolicy.size_task`, :meth:`~ProtocolPolicy.should_aggregate`
and :meth:`~ProtocolPolicy.weighting`.

:class:`SyncProtocol` runs the paper's stress-test setting: every selected
learner runs the same number of local steps, and the engine aggregates when
*all* uploads arrived (FedAvg).  Semi-sync, async, FedBuff, deadline-cohort
and reputation policies are slice B of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.selection import SelectionPolicy, select_learners

__all__ = ["TrainTask", "LearnerProfile", "ProtocolPolicy", "SyncProtocol"]


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
    #: each aggregate; continuous ones (slice B) aggregate per arrival.
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
        raise NotImplementedError

    def should_aggregate(self, arrived: int, cohort_size: int) -> bool:
        """True when the engine should fire an aggregation event."""
        return arrived >= cohort_size

    def weighting(self) -> str:
        """Arena row weighting at the reduce: ``"fedavg"`` or ``"staleness"``."""
        return "fedavg"


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
