"""Global (server-side) optimizers over packed buffers.

The port of ``repro/core/server_opt.py``: the aggregated learner average
defines a pseudo-gradient ``Δ = x_global - x_agg`` that a server optimizer
consumes (Reddi et al., *Adaptive Federated Optimization*).  All states and
updates are flat ``(P,)`` tensors on the controller's device; each rule is a
few elementwise tensor ops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["ServerOptState", "ServerOptimizer", "make_server_optimizer"]


class ServerOptState(NamedTuple):
    """Adaptive-server state: step counter plus first/second moments."""

    step: int
    m: torch.Tensor  # first moment, (P,)
    v: torch.Tensor  # second moment, (P,)


@dataclasses.dataclass(frozen=True)
class ServerOptimizer:
    """An (init, apply) pair over packed buffers."""

    name: str
    init: Callable[[torch.Tensor], ServerOptState]
    # (state, x_global, x_agg) -> (new_state, new_x_global)
    apply: Callable[
        [ServerOptState, torch.Tensor, torch.Tensor], tuple[ServerOptState, torch.Tensor]
    ]


def make_server_optimizer(
    name: str = "fedavg",
    lr: float = 1.0,
    beta1: float = 0.9,
    beta2: float = 0.99,
    eps: float = 1e-3,
    momentum: float = 0.9,
) -> ServerOptimizer:
    """Build a server optimizer: fedavg | sgdm | fedadagrad | fedyogi | fedadam."""

    def init(x: torch.Tensor) -> ServerOptState:
        z = torch.zeros_like(x, dtype=torch.float32)
        return ServerOptState(step=0, m=z, v=z)

    def _delta(x_global, x_agg):
        # server pseudo-gradient: direction from global towards the average
        return x_global.to(torch.float32) - x_agg.to(torch.float32)

    if name == "fedavg":

        def apply(state, x_global, x_agg):
            # plain replacement (lr=1) or a server learning rate interpolation
            new = x_global.to(torch.float32) - lr * _delta(x_global, x_agg)
            return state._replace(step=state.step + 1), new

    elif name == "sgdm":

        def apply(state, x_global, x_agg):
            g = _delta(x_global, x_agg)
            m = momentum * state.m + g
            new = x_global.to(torch.float32) - lr * m
            return ServerOptState(state.step + 1, m, state.v), new

    elif name in ("fedadagrad", "fedyogi", "fedadam"):

        def apply(state, x_global, x_agg):
            g = _delta(x_global, x_agg)
            m = beta1 * state.m + (1.0 - beta1) * g
            g2 = g * g
            if name == "fedadagrad":
                v = state.v + g2
            elif name == "fedyogi":
                v = state.v - (1.0 - beta2) * g2 * torch.sign(state.v - g2)
            else:  # fedadam
                v = beta2 * state.v + (1.0 - beta2) * g2
            new = x_global.to(torch.float32) - lr * m / (torch.sqrt(v) + eps)
            return ServerOptState(state.step + 1, m, v), new

    else:
        raise ValueError(f"unknown server optimizer: {name}")

    return ServerOptimizer(name=name, init=init, apply=apply)
