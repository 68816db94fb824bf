"""The paper's HousingMLP: a 100-hidden-layer regression MLP, in PyTorch.

The port of ``repro/models/mlp.py``.  Parameters are a plain tree —
``{"layers": [{"w", "b"}, ...], "out": {"w", "b"}}`` — with weights laid out
``(d_in, width)`` as in the reference, so the learner's
``loss_fn(params, batch)`` contract and the packed wire layout are the same.
Weights from the reference carry across with
``core/packing.tree_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.housing_mlp import MLPConfig

__all__ = ["init_params", "apply", "mse_loss"]


def init_params(generator: torch.Generator, cfg: MLPConfig, device: torch.device | str):
    """Random init from ``generator``: ``N(0, 1/d_in)`` weights, zero biases.

    Same distribution as the reference's, not the same numbers (a torch
    generator is not JAX's threefry); tests carry the reference's init across
    instead.
    """

    def normal(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
        return (w * (1.0 / math.sqrt(d_in))).to(device)

    params = {"layers": []}
    d_in = cfg.n_features
    for _ in range(cfg.n_hidden_layers):
        params["layers"].append(
            {"w": normal(d_in, cfg.width), "b": torch.zeros((cfg.width,), device=device)}
        )
        d_in = cfg.width
    params["out"] = {
        "w": normal(d_in, cfg.n_outputs),
        "b": torch.zeros((cfg.n_outputs,), device=device),
    }
    return params


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: ReLU hidden layers, linear output."""
    for layer in params["layers"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def mse_loss(params, batch) -> torch.Tensor:
    """Mean squared error of the MLP on one ``(x, y)`` batch."""
    x, y = batch
    pred = apply(params, x)
    return torch.mean((pred - y) ** 2)
