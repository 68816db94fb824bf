"""Local optimizers of the port."""

from repro_torch.optim.optimizers import (
    AdafactorState,
    AdamState,
    Optimizer,
    OptState,
    adafactor,
    adam,
    adamw,
    apply_fedprox,
    momentum,
    sgd,
)

__all__ = [
    "Optimizer",
    "OptState",
    "AdamState",
    "AdafactorState",
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "adafactor",
    "apply_fedprox",
]
