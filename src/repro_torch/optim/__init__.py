"""Local optimizers of the port."""

from repro_torch.optim.optimizers import Optimizer, OptState, apply_fedprox, sgd

__all__ = ["Optimizer", "OptState", "sgd", "apply_fedprox"]
