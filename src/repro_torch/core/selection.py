"""Learner selection policies for the federation controller.

Before each training/evaluation round the controller *selects* the
participating learners (paper Figs. 9/10: "select learners" precedes task
scheduling).  The paper's stress tests use full participation; production
controllers also sample.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["SelectionPolicy", "select_learners"]


@dataclasses.dataclass(frozen=True)
class SelectionPolicy:
    """How the controller picks each round's cohort: everyone (``all``),
    uniformly at random, or dataset-size-weighted (``stratified``)."""

    kind: str = "all"  # all | random | stratified
    fraction: float = 1.0  # for random/stratified: fraction of learners per round
    min_learners: int = 1
    seed: int = 0


def select_learners(
    policy: SelectionPolicy,
    learner_ids: Sequence[str],
    round_id: int,
    num_examples: dict[str, int] | None = None,
) -> list[str]:
    """Select the round's participants per ``policy`` (deterministic in
    ``(seed, round_id)`` so runs are reproducible)."""
    ids = list(learner_ids)
    if not ids:
        return []
    if policy.kind == "all":
        return ids

    k = max(policy.min_learners, int(round(policy.fraction * len(ids))))
    k = min(k, len(ids))
    rng = np.random.default_rng(np.uint32(policy.seed) + np.uint32(round_id))

    if policy.kind == "random":
        return [ids[i] for i in rng.choice(len(ids), size=k, replace=False)]

    if policy.kind == "stratified":
        # Sample proportionally to dataset size (larger silos more likely),
        # without replacement — a simple importance-sampling selection.
        if not num_examples:
            raise ValueError("stratified selection needs num_examples")
        w = np.array([num_examples.get(i, 1) for i in ids], dtype=np.float64)
        w = w / w.sum()
        return [ids[i] for i in rng.choice(len(ids), size=k, replace=False, p=w)]

    raise ValueError(f"unknown selection kind: {policy.kind}")
