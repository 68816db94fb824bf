"""Federated data partitioning: IID and Dirichlet non-IID.

A pure-numpy copy of ``repro/data/partition.py``.

The paper samples 100 examples per learner with replacement (pure stress
test); production FL experiments additionally need realistic non-IID silos,
so we provide the standard Dirichlet(α) label-skew partitioner used across
the FL literature (lower α → more skew).
"""

from __future__ import annotations

import numpy as np

__all__ = ["iid_partition", "dirichlet_partition"]


def iid_partition(
    n_examples: int, n_learners: int, seed: int = 0,
    per_learner: int | None = None, with_replacement: bool = False,
) -> list[np.ndarray]:
    """Uniform split (or fixed-size sample per learner, paper-style)."""
    rng = np.random.default_rng(seed)
    if per_learner is not None:
        return [
            rng.choice(n_examples, size=per_learner, replace=with_replacement)
            for _ in range(n_learners)
        ]
    perm = rng.permutation(n_examples)
    return [np.sort(chunk) for chunk in np.array_split(perm, n_learners)]


def dirichlet_partition(
    labels: np.ndarray, n_learners: int, alpha: float = 0.5, seed: int = 0,
    min_per_learner: int = 1,
) -> list[np.ndarray]:
    """Label-skew partition: per class, split indices by Dirichlet(α) shares."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shards: list[list[np.ndarray]] = [[] for _ in range(n_learners)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        shares = rng.dirichlet([alpha] * n_learners)
        cuts = (np.cumsum(shares)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            shards[i].append(part)
    out = [np.sort(np.concatenate(s)) if s else np.array([], np.int64) for s in shards]
    # guarantee non-empty silos
    pool = np.concatenate(out) if any(len(o) for o in out) else np.arange(len(labels))
    for i, o in enumerate(out):
        if len(o) < min_per_learner:
            extra = rng.choice(pool, size=min_per_learner - len(o), replace=True)
            out[i] = np.sort(np.concatenate([o, extra]))
    return out
