"""Deterministic, seeded fault injection: churn, stragglers, byzantine uploads.

The port of ``repro/core/faults.py``.  Every stochastic decision (who drops
out, whose upload is lost or duplicated, how badly a straggler's step time
inflates, what bandwidth cap a learner gets, which learners are byzantine and
which corruption they apply) is drawn from its own
``numpy.random.default_rng`` seeded by ``(spec.seed, *crc32(key))``, where
the key names the decision (``("fate", learner_id, round_id)`` etc.) — so
outcomes are a pure function of the fault seed and the decision's identity,
never of thread timing or draw order, and they equal the reference's for the
same spec and ids.

Fault taxonomy (all knobs on :class:`FaultSpec`):

- **Churn** — per-round learner dropout (``dropout_rate``) and rejoin
  (``rejoin_rate``), floor-guarded by ``min_active``.
- **Upload faults** — loss (``upload_loss_rate``) and duplication
  (``upload_dup_rate``), decided per ``(learner, round)`` by
  :meth:`FaultInjector.upload_fate` and stamped into upload metadata by
  :class:`FaultyChannel`; the round engine (``core/engine.py``) enacts
  them: a ``lost`` upload is never ingested, a ``dup`` one is delivered
  twice (counted in ``engine.faults.uploads_lost`` / ``uploads_duplicated``).
- **Stragglers** — a fixed ``straggler_rate`` subset of learners whose step
  time is inflated by a Pareto-tailed factor (``straggler_tail``).
- **Bandwidth caps** — per-learner log-uniform caps between
  ``bandwidth_min_gbps`` and ``bandwidth_max_gbps``.
- **Adversaries** — a fixed ``adversarial_fraction`` subset of learners
  (byzantine clients) whose upload *payloads* are corrupted in flight: each
  round one fate is drawn from ``adversarial_fates`` (``"nan"``, ``"scale"``
  by ``adversarial_scale``, ``"sign_flip"``, ``"garbage"``) and applied by
  :class:`FaultyChannel` to the torch upload buffer, on its own device,
  before the envelope is minted.  Corruption only applies when the transport
  fate is ``"ok"``.

Counters land under ``engine.faults.*`` in the controller's telemetry
(``stragglers`` here, ``adversarial.<fate>`` in the channel,
``dropouts``/``rejoins`` in the controller).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.transport import Channel

__all__ = ["ADVERSARIAL_FATES", "FaultSpec", "FaultInjector", "FaultyChannel"]

#: The byzantine payload corruptions FaultyChannel can stamp onto uploads.
ADVERSARIAL_FATES = ("nan", "scale", "sign_flip", "garbage")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault model for one stress run (all rates in [0, 1]).

    ``seed`` is the *only* source of randomness — same spec, same faults.
    ``base_step_time_s`` is the healthy simulated seconds-per-step that
    straggler inflation multiplies.  Bandwidth caps are disabled when
    either bound is 0.  ``min_active`` floors churn so the federation
    never drops below a quorum.
    """

    seed: int = 0
    dropout_rate: float = 0.0
    rejoin_rate: float = 0.0
    upload_loss_rate: float = 0.0
    upload_dup_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_tail: float = 1.5
    base_step_time_s: float = 1e-4
    bandwidth_min_gbps: float = 0.0
    bandwidth_max_gbps: float = 0.0
    min_active: int = 1
    # Byzantine clients: a fixed adversarial_fraction of learners corrupt
    # every upload payload, drawing one fate per round from
    # adversarial_fates (see ADVERSARIAL_FATES).  "scale" multiplies the
    # buffer by adversarial_scale.
    adversarial_fraction: float = 0.0
    adversarial_fates: tuple = ("scale", "sign_flip")
    adversarial_scale: float = 100.0

    def __post_init__(self):
        """Validate rates, tail, and bandwidth bounds at construction."""
        for f in ("dropout_rate", "rejoin_rate", "upload_loss_rate",
                  "upload_dup_rate", "straggler_rate",
                  "adversarial_fraction"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.upload_loss_rate + self.upload_dup_rate > 1.0:
            raise ValueError("upload_loss_rate + upload_dup_rate must be <= 1")
        if self.straggler_tail <= 0:
            raise ValueError("straggler_tail must be positive")
        if self.base_step_time_s <= 0:
            raise ValueError("base_step_time_s must be positive")
        if self.bandwidth_min_gbps < 0 or self.bandwidth_max_gbps < 0:
            raise ValueError("bandwidth bounds must be >= 0")
        if (self.bandwidth_min_gbps > 0) != (self.bandwidth_max_gbps > 0):
            raise ValueError("set both bandwidth bounds or neither")
        if self.bandwidth_min_gbps > self.bandwidth_max_gbps:
            raise ValueError("bandwidth_min_gbps must be <= bandwidth_max_gbps")
        if self.min_active < 1:
            raise ValueError("min_active must be >= 1")
        object.__setattr__(
            self, "adversarial_fates", tuple(self.adversarial_fates)
        )
        if self.adversarial_fraction > 0:
            if not self.adversarial_fates:
                raise ValueError(
                    "adversarial_fraction > 0 needs at least one fate in "
                    "adversarial_fates"
                )
            unknown = [f for f in self.adversarial_fates
                       if f not in ADVERSARIAL_FATES]
            if unknown:
                raise ValueError(
                    f"unknown adversarial fate(s) {unknown}; "
                    f"valid: {ADVERSARIAL_FATES}"
                )
        if self.adversarial_scale <= 0:
            raise ValueError("adversarial_scale must be positive")


class FaultInjector:
    """Draws every fault decision from ``(seed, decision-key)``-keyed rngs.

    Stateless per decision — the only mutable state is the ``_down`` roster
    that :meth:`churn` maintains so rejoins target actually-dropped
    learners.  Pass the controller's ``Telemetry`` to count straggler
    inflations under ``engine.faults.stragglers``.
    """

    def __init__(self, spec: FaultSpec, telemetry: Any = None):
        """Bind a spec; optionally a Telemetry for the straggler counter."""
        self.spec = spec
        self._down: dict[str, int] = {}
        self._c_stragglers = (
            telemetry.counter("engine.faults.stragglers")
            if telemetry is not None else None
        )

    def _rng(self, *key: Any) -> np.random.Generator:
        """A fresh generator for one named decision (order-independent).

        Seed material is ``[spec.seed] + crc32(str(k))`` per key part —
        crc32, not ``hash()``, because Python string hashing is salted
        per process and would break cross-run determinism.
        """
        return np.random.default_rng(
            [self.spec.seed & 0xFFFFFFFF]
            + [zlib.crc32(str(k).encode()) for k in key]
        )

    # -- stragglers ---------------------------------------------------------
    def is_straggler(self, learner_id: str) -> bool:
        """Whether this learner belongs to the fixed straggler subset."""
        if self.spec.straggler_rate <= 0:
            return False
        return bool(
            self._rng("straggler", learner_id).uniform()
            < self.spec.straggler_rate
        )

    def step_time(self, learner_id: str, round_id: int) -> float:
        """Simulated seconds-per-step for one fit (Pareto-inflated tail).

        Healthy learners report ``base_step_time_s``; stragglers multiply
        it by ``(1 - u)^(-1/tail)`` — a Pareto draw whose tail index is
        ``straggler_tail`` (heavier for smaller values), redrawn per round.
        """
        t = self.spec.base_step_time_s
        if self.is_straggler(learner_id):
            u = self._rng("steptime", learner_id, round_id).uniform()
            t *= float((1.0 - u) ** (-1.0 / self.spec.straggler_tail))
            if self._c_stragglers is not None:
                self._c_stragglers.add(1)
        return t

    # -- bandwidth ----------------------------------------------------------
    def bandwidth_cap(self, learner_id: str) -> float | None:
        """Per-learner log-uniform bandwidth cap in Gbps (None = uncapped)."""
        lo, hi = self.spec.bandwidth_min_gbps, self.spec.bandwidth_max_gbps
        if lo <= 0:
            return None
        u = self._rng("bandwidth", learner_id).uniform()
        return float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))

    # -- upload fate --------------------------------------------------------
    def upload_fate(self, learner_id: str, round_id: int) -> str:
        """Fate of one upload: ``"lost"``, ``"dup"``, or ``"ok"``.

        One uniform draw per ``(learner, round)`` split against the loss
        then loss+dup thresholds, so the three outcomes are mutually
        exclusive and individually seeded.
        """
        loss, dup = self.spec.upload_loss_rate, self.spec.upload_dup_rate
        if loss <= 0 and dup <= 0:
            return "ok"
        u = self._rng("fate", learner_id, round_id).uniform()
        if u < loss:
            return "lost"
        if u < loss + dup:
            return "dup"
        return "ok"

    # -- adversaries --------------------------------------------------------
    def is_adversarial(self, learner_id: str) -> bool:
        """Whether this learner belongs to the fixed byzantine subset."""
        if self.spec.adversarial_fraction <= 0:
            return False
        return bool(
            self._rng("adversary", learner_id).uniform()
            < self.spec.adversarial_fraction
        )

    def adversarial_fate(self, learner_id: str, round_id: int) -> str | None:
        """The payload corruption for one upload (None for honest learners).

        Adversaries corrupt *every* upload; which fate they apply is
        redrawn per ``(learner, round)`` from ``spec.adversarial_fates``.
        """
        if not self.is_adversarial(learner_id):
            return None
        fates = self.spec.adversarial_fates
        if len(fates) == 1:
            return fates[0]
        i = int(self._rng("advfate", learner_id, round_id).integers(len(fates)))
        return fates[i]

    def corrupt(
        self, buffer: torch.Tensor, fate: str, learner_id: str, round_id: int
    ) -> torch.Tensor:
        """Apply one adversarial fate to an upload buffer (a new tensor on
        the buffer's device; the learner's buffer is left as it was).

        ``"nan"`` poisons the whole buffer (any single NaN makes the L2
        norm non-finite, so the admission screen rejects it); ``"scale"``
        and ``"sign_flip"`` stay finite — scale blow-ups are clippable,
        sign flips are norm-invariant and *invisible* to the screen, which
        is exactly why they need a robust aggregation rule.  ``"garbage"``
        replaces the payload with finite uniform noise drawn on the host
        from the decision-keyed rng, exactly as the reference draws it, and
        copied to the device, so its bytes equal the reference's.
        """
        if fate == "nan":
            return torch.full_like(buffer, torch.nan)
        if fate == "scale":
            return buffer * self.spec.adversarial_scale
        if fate == "sign_flip":
            return -buffer
        if fate == "garbage":
            rng = self._rng("garbage", learner_id, round_id)
            noise = rng.uniform(-1.0, 1.0, size=tuple(buffer.shape))
            return torch.from_numpy(noise).to(buffer.dtype).to(buffer.device)
        # spec validation rejects unknown fates
        raise ValueError(f"unknown adversarial fate {fate!r}")  # pragma: no cover

    # -- churn --------------------------------------------------------------
    def churn(
        self, round_id: int, active_ids: list[str]
    ) -> tuple[list[str], list[str]]:
        """Per-round membership churn: who leaves, who rejoins.

        Each active learner leaves with ``dropout_rate`` (floor-guarded so
        at least ``min_active`` stay); each currently-down learner rejoins
        with ``rejoin_rate``.  Down learners are iterated in sorted order
        and both decisions are per-``(learner, round)`` seeded, so churn
        is deterministic regardless of caller iteration order.  Updates
        the internal down-roster; returns ``(leave, rejoin)`` id lists.
        """
        spec = self.spec
        leave: list[str] = []
        if spec.dropout_rate > 0:
            budget = len(active_ids) - spec.min_active
            for lid in active_ids:
                if budget <= 0:
                    break
                if self._rng("drop", lid, round_id).uniform() < spec.dropout_rate:
                    leave.append(lid)
                    budget -= 1
        rejoin: list[str] = []
        if spec.rejoin_rate > 0:
            for lid in sorted(self._down):
                if self._rng("rejoin", lid, round_id).uniform() < spec.rejoin_rate:
                    rejoin.append(lid)
        for lid in leave:
            self._down[lid] = int(round_id)
        for lid in rejoin:
            self._down.pop(lid, None)
        return leave, rejoin


class FaultyChannel(Channel):
    """A :class:`Channel` whose uplink stamps fault fates into metadata.

    ``upload()`` consults the injector's :meth:`FaultInjector.upload_fate`
    for the sending ``(learner_id, round_id)`` and, when the fate is not
    ``"ok"``, writes ``metadata["fault"] = "lost"|"dup"`` before minting the
    envelope (the round engine enacts it).

    Byzantine learners additionally have their payload corrupted in flight
    (:meth:`FaultInjector.corrupt`) with the fate stamped as
    ``metadata["adversarial"]`` and counted under
    ``engine.faults.adversarial.<fate>`` — but only when the transport fate
    is ``"ok"``.  Takes the :class:`Channel`'s keyword arguments, ``device=``
    included.
    """

    def __init__(self, injector: FaultInjector, **kwargs: Any):
        """A measured channel bound to one fault injector."""
        super().__init__(**kwargs)
        self.injector = injector
        self._adv_counters = {
            fate: self.telemetry.counter(f"engine.faults.adversarial.{fate}")
            for fate in ADVERSARIAL_FATES
        }

    def upload(
        self, buffer: torch.Tensor, metadata: dict | None = None, codec: Any = None
    ) -> Any:
        """Encode one upload, stamping its injected fate into metadata."""
        md = dict(metadata or {})
        lid, rid = md.get("learner_id"), md.get("round_id")
        if lid is not None and rid is not None:
            fate = self.injector.upload_fate(lid, int(rid))
            if fate != "ok":
                md["fault"] = fate
            else:
                # Scripted/duck-typed injectors in tests may only implement
                # upload_fate; adversarial corruption is opt-in.
                adv_fate = getattr(self.injector, "adversarial_fate", None)
                adv = adv_fate(lid, int(rid)) if adv_fate is not None else None
                if adv is not None:
                    buffer = self.injector.corrupt(buffer, adv, lid, int(rid))
                    md["adversarial"] = adv
                    self._adv_counters[adv].add(1)
        return super().upload(buffer, metadata=md, codec=codec)
