"""The paper's stress-test model: 100-hidden-layer HousingMLP.

A framework-free copy of ``repro/configs/housing_mlp.py``.

§4.2: "we define an MLP architecture with 100 densely connected (hidden)
layers and a constant number of parameters per layer — 100k: 32 params/layer,
1M: 100 params/layer, 10M: 320 params/layer" — i.e. hidden widths 32 / 100 /
320, trained on a housing regression task with Vanilla SGD, batch 100.
"""

from __future__ import annotations

import dataclasses

ARCH_ID = "housing-mlp"

# width -> (label, approx params)
SIZES = {"100k": 32, "1m": 100, "10m": 320}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """One housing-MLP size: depth, width, input and output features."""

    name: str
    n_hidden_layers: int
    width: int
    n_features: int = 13  # housing dataset feature count
    n_outputs: int = 1

    @property
    def param_count(self) -> int:
        """Total parameters: every layer's weights plus biases."""
        w, L = self.width, self.n_hidden_layers
        total = self.n_features * w + w
        total += (L - 1) * (w * w + w)
        total += w * self.n_outputs + self.n_outputs
        return total


def config(size: str = "10m") -> MLPConfig:
    """The paper's stress-test MLP at ``size`` (100k / 1m / 10m params)."""
    if size not in SIZES:
        raise ValueError(f"size must be one of {list(SIZES)}")
    return MLPConfig(name=f"{ARCH_ID}-{size}", n_hidden_layers=100, width=SIZES[size])


def reduced() -> MLPConfig:
    """A 4-layer, width-16 smoke variant for tests."""
    return MLPConfig(name=f"{ARCH_ID}-smoke", n_hidden_layers=4, width=16)
