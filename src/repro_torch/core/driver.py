"""The Federation Driver: initialization → monitoring → shutdown (Fig. 8).

The port of ``repro/core/driver.py``.  The driver reads the federated
environment, creates the controller (with its channel and store), ships the
initial model state, monitors the federation with heartbeats, and tears it
down in the paper's order (learners first, then controller).  Everything runs
on ``FederationEnv.device``: the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Sequence

import torch

from repro_torch.core.config import FederationConfig
from repro_torch.core.controller import Controller
from repro_torch.core.engine import RoundTimings
from repro_torch.core.learner import Learner
from repro_torch.core.scheduler import (
    AsyncProtocol,
    BufferedAsyncProtocol,
    DeadlineCohortProtocol,
    ReputationProtocol,
    SemiSyncProtocol,
    SyncProtocol,
)
from repro_torch.core.selection import SelectionPolicy
from repro_torch.core.server_opt import make_server_optimizer
from repro_torch.core.store import ModelStore
from repro_torch.core.transport import Channel
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_controller_mesh

log = logging.getLogger("repro_torch.driver")

__all__ = ["FederationEnv", "TerminationCriteria", "Driver"]

@dataclasses.dataclass(frozen=True)
class TerminationCriteria:
    """Federated-training termination signals (paper Fig. 8)."""

    max_rounds: int = 10
    max_wallclock_s: float | None = None
    target_metric: str | None = None  # e.g. "eval_loss"
    target_value: float | None = None
    target_mode: str = "min"  # min | max


@dataclasses.dataclass(frozen=True)
class FederationEnv:
    """The YAML-equivalent federated-environment description.

    Workflow knobs live here as flat fields; the machinery knobs are one
    validated :class:`~repro_torch.core.config.FederationConfig` at
    :attr:`config`, with the flat machinery fields as aliases (as in the
    reference).  ``device`` is where the federation runs;
    ``max_dispatch_workers`` bounds the learners training at once (the
    controller's 32 by default; a model whose learners do not all fit in
    device memory at once needs fewer).
    """

    protocol: str = "sync"  # sync|semi_sync|async|buffered_async|deadline|reputation
    local_steps: int = 1
    batch_size: int = 100
    learning_rate: float = 0.01
    hyperperiod_s: float = 1.0
    staleness_alpha: float = 0.5
    prox_mu: float = 0.0
    selection: SelectionPolicy = SelectionPolicy()
    server_optimizer: str = "fedavg"
    server_lr: float = 1.0
    secure_aggregation: bool = False
    lineage_length: int = 1
    store_capacity_bytes: int | None = None
    # "arena" | "stack" | "auto": auto picks the hash-map store when its
    # exclusive features (lineage > 1, byte-capacity eviction) are set.
    store_mode: str = "auto"
    arena_shards: int = 0
    flat_uploads: bool = True
    upload_codec: str = "raw"
    arena_dtype: str = "f32"
    sparse_mode: str = "densify"
    profile_decay: float = 0.5
    wire_aware: bool = True
    # Buffered-async (FedBuff) only: aggregate every K arrivals.
    buffer_k: int = 8
    # Deadline-cohort only: wall-clock budget a cohort member's predicted
    # round trip must fit inside.
    deadline_s: float = 1.0
    # Reputation only: top fraction of ranked learners kept per round.
    reputation_fraction: float = 0.5
    aggregation_rule: str = "fedavg"
    trim_k: int = 1
    bandwidth_gbps: float = 10.0
    latency_ms: float = 0.5
    heartbeat_every_s: float = 5.0
    termination: TerminationCriteria = TerminationCriteria()
    config: FederationConfig | None = None
    device: str | torch.device | None = None
    max_dispatch_workers: int = 32

    def __post_init__(self) -> None:
        """Reconcile the typed config with the flat alias fields."""
        fields = (
            "store_mode", "arena_shards", "upload_codec", "flat_uploads",
            "wire_aware", "profile_decay", "prox_mu",
            "aggregation_rule", "trim_k", "arena_dtype", "sparse_mode",
        )
        if self.config is None:
            object.__setattr__(
                self, "config", FederationConfig(**{f: getattr(self, f) for f in fields})
            )
        else:
            for field in fields:
                object.__setattr__(self, field, getattr(self.config, field))

    def make_protocol(self):
        """Instantiate the protocol policy this environment describes."""
        if self.protocol == "sync":
            return SyncProtocol(self.local_steps, self.batch_size, self.learning_rate,
                                prox_mu=self.prox_mu)
        if self.protocol == "semi_sync":
            return SemiSyncProtocol(
                self.hyperperiod_s, self.batch_size, self.learning_rate,
                default_steps=self.local_steps, prox_mu=self.prox_mu,
                wire_aware=self.wire_aware,
            )
        if self.protocol == "async":
            return AsyncProtocol(
                self.local_steps, self.batch_size, self.learning_rate,
                self.staleness_alpha, prox_mu=self.prox_mu,
            )
        if self.protocol == "buffered_async":
            return BufferedAsyncProtocol(
                buffer_k=self.buffer_k, local_steps=self.local_steps,
                batch_size=self.batch_size, learning_rate=self.learning_rate,
                staleness_alpha=self.staleness_alpha, prox_mu=self.prox_mu,
            )
        if self.protocol == "deadline":
            return DeadlineCohortProtocol(
                deadline_s=self.deadline_s, local_steps=self.local_steps,
                batch_size=self.batch_size, learning_rate=self.learning_rate,
                prox_mu=self.prox_mu,
            )
        if self.protocol == "reputation":
            return ReputationProtocol(
                fraction=self.reputation_fraction,
                local_steps=self.local_steps, batch_size=self.batch_size,
                learning_rate=self.learning_rate, prox_mu=self.prox_mu,
            )
        raise ValueError(f"unknown protocol {self.protocol}")


class Driver:
    """Owns the federation lifecycle."""

    def __init__(self, env: FederationEnv, aggregate_fn=None):
        self.env = env
        self.device = resolve_device(env.device)
        cfg = env.config
        store_mode = env.store_mode
        if store_mode == "auto":
            wants_hash_map = env.lineage_length > 1 or env.store_capacity_bytes is not None
            store_mode = "stack" if wants_hash_map else "arena"
        arena_mesh = None
        if env.arena_shards and env.store_mode == "stack":
            # Mirror Controller's arena_mesh+stack refusal: an explicitly
            # requested stack store cannot be sharded; only the auto pick
            # (lineage or eviction configured) drops the knob.
            raise ValueError(
                "arena_shards requires an arena store; it cannot combine with "
                "store_mode='stack'"
            )
        if env.arena_shards and store_mode == "arena":
            arena_mesh = make_controller_mesh(
                None if env.arena_shards < 0 else env.arena_shards, self.device
            )
        self.controller = Controller(
            protocol=env.make_protocol(),
            selection=env.selection,
            aggregate_fn=aggregate_fn,
            server_optimizer=make_server_optimizer(env.server_optimizer, lr=env.server_lr),
            store=(
                ModelStore(env.lineage_length, env.store_capacity_bytes)
                if store_mode == "stack" else None
            ),
            channel=Channel(env.bandwidth_gbps, env.latency_ms,
                            upload_codec=env.upload_codec, device=self.device),
            secure=env.secure_aggregation,
            store_mode=store_mode,
            arena_mesh=arena_mesh,
            flat_uploads=env.flat_uploads,
            profile_decay=env.profile_decay,
            aggregation_rule=env.aggregation_rule,
            trim_k=env.trim_k,
            arena_dtype=env.arena_dtype,
            sparse_mode=env.sparse_mode,
            journal_sink=cfg.journal_sink,
            journal_capacity=cfg.journal_capacity,
            checkpoint_every=cfg.checkpoint_every,
            checkpoint_dir=cfg.checkpoint_dir,
            max_dispatch_workers=env.max_dispatch_workers,
            device=self.device,
        )
        self._learners: list[Learner] = []
        self._last_heartbeat = 0.0

    # -- initialization (Fig. 8 top) ----------------------------------------
    def initialize(self, initial_params: Any, learners: Sequence[Learner]) -> None:
        """Ship the initial model and register live learners (Fig. 8 init)."""
        log.info("driver: initializing controller with model state")
        self.controller.set_initial_model(initial_params)
        for learner in learners:
            if not learner.ping():
                raise RuntimeError(f"learner {learner.learner_id} not alive at init")
            self.controller.register_learner(learner)
            self._learners.append(learner)
        log.info("driver: %d learners registered", len(learners))

    # -- monitoring ----------------------------------------------------------
    def _heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_heartbeat < self.env.heartbeat_every_s:
            return
        self._last_heartbeat = now
        dead = [l.learner_id for l in self._learners if not l.ping()]
        if dead:
            raise RuntimeError(f"dead learners detected: {dead}")

    def _terminated(self, t_start: float, history: list[RoundTimings]) -> bool:
        crit = self.env.termination
        if len(history) >= crit.max_rounds:
            return True
        if crit.max_wallclock_s is not None and time.monotonic() - t_start > crit.max_wallclock_s:
            return True
        if crit.target_metric and history and crit.target_value is not None:
            val = history[-1].metrics.get(crit.target_metric)
            if val is not None:
                if crit.target_mode == "min" and val <= crit.target_value:
                    return True
                if crit.target_mode == "max" and val >= crit.target_value:
                    return True
        return False

    # -- run ------------------------------------------------------------------
    def run(self) -> list[RoundTimings]:
        """Run the federation until termination fires: round-based policies
        one engine loop a round, continuous ones ``max_rounds`` community
        updates in one loop."""
        t_start = time.monotonic()
        history: list[RoundTimings] = []
        engine = self.controller.engine
        if getattr(self.controller.protocol, "continuous", False):
            history = engine.run(total_updates=self.env.termination.max_rounds)
        else:
            while not self._terminated(t_start, history):
                self._heartbeat()
                timings = engine.run(rounds=1)[0]
                history.append(timings)
                log.info(
                    "round %d: fed=%.3fs agg=%.4fs metrics=%s",
                    timings.round_id, timings.federation_round_s,
                    timings.aggregation_s, timings.metrics,
                )
        self.shutdown()
        return history

    # -- shutdown (learners first, then controller) ---------------------------
    def shutdown(self) -> None:
        """Tear the federation down: learners first, then the controller."""
        for learner in self._learners:
            learner.shutdown()
        self.controller.shutdown()
        log.info("driver: federation shut down")
