"""Local (learner-side) optimizers as pure tree transforms.

The port of ``repro/optim/optimizers.py`` for the slice: ``init(params) ->
state``, ``update(grads, state, params) -> (updates, state)``, with
``Optimizer.apply`` returning fresh tensors (no in-place update of the
caller's params).  Momentum, Adam, AdamW and Adafactor are queued for a later
slice of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import flatten, tree_map

__all__ = ["Optimizer", "OptState", "sgd", "apply_fedprox"]

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An ``(init, update)`` pair over parameter trees."""

    name: str
    init: Callable[[Any], OptState]
    # (grads, state, params) -> (updates, new_state); apply: p + u
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]

    def apply(self, params: Any, grads: Any, state: OptState) -> tuple[Any, OptState]:
        """One step: ``params + update(grads)``, as new tensors."""
        updates, state = self.update(grads, state, params)
        return tree_map(lambda p, u: p + u, params, updates), state


def sgd(lr: float) -> Optimizer:
    """Vanilla SGD (the paper's stress-test optimizer)."""

    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer("sgd", init, update)


def apply_fedprox(loss_fn: Callable, mu: float, global_params: Any) -> Callable:
    """Wrap a local loss with the FedProx proximal term μ/2‖w − w_global‖²."""

    def prox_loss(params, *args, **kwargs):
        base = loss_fn(params, *args, **kwargs)
        sq = sum(
            torch.sum((p - g.to(p.dtype)) ** 2)
            for p, g in zip(flatten(params)[0], flatten(global_params)[0])
        )
        return base + 0.5 * mu * sq

    return prox_loss
