"""Kernel dispatch: the hand-written kernel on the card, plain torch on the host.

The port of ``repro/kernels/ops.py`` for the slice's kernels.  The device of
the input decides, and nothing else:

* a CUDA tensor goes to the Hopper kernel — a failed build or launch raises;
  there is no fallback to the plain version or to the CPU;
* a CPU tensor goes to the plain PyTorch version (the parity tests' path);
* any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedavg as _fedavg

__all__ = ["fedavg", "masked_fedavg"]


def _route(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device {x.device}; use cuda or cpu")
    return kind


def fedavg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """FedAvg over a packed ``(N, P)`` stack (uniform when Σw = 0)."""
    if _route(stack) == "cuda":
        return _fedavg.fedavg_cuda(stack, weights)
    return _fedavg.fedavg_torch(stack, weights)


def masked_fedavg(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked FedAvg over the device-resident ``(N_max, P)`` arena."""
    if _route(arena) == "cuda":
        return _fedavg.masked_fedavg_cuda(arena, weights, mask)
    return _fedavg.masked_fedavg_torch(arena, weights, mask)
