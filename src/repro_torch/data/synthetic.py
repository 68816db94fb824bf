"""Synthetic datasets: the paper's housing regression + LM token streams.

A pure-numpy copy of ``repro/data/synthetic.py``: the same seeds give
bit-identical data in both packages.

``make_housing_data`` regenerates a HousingMLP-style regression task (13
features, scalar target with a fixed nonlinear ground truth + noise) — the
paper uses the Boston housing set purely as a stress-test carrier, so a
statistically matched synthetic stands in (offline container, no downloads).

``make_lm_data``/``LMDataIterator`` provide deterministic token streams for
the transformer architectures (Zipf-distributed ids so the loss actually
decreases under training).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HousingData", "make_housing_data", "make_lm_data", "LMDataIterator"]


@dataclasses.dataclass
class HousingData:
    """Features ``x`` and targets ``y`` of the housing regression task."""

    x: np.ndarray  # (N, 13) float32
    y: np.ndarray  # (N, 1) float32


def make_housing_data(n: int = 506, seed: int = 0, noise: float = 0.1) -> HousingData:
    """``n`` examples of 13 features and a fixed nonlinear target plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 13)).astype(np.float32)
    w1 = rng.normal(size=(13,)).astype(np.float32)
    w2 = rng.normal(size=(13,)).astype(np.float32)
    y = x @ w1 + 0.5 * np.tanh(x @ w2) + noise * rng.normal(size=(n,)).astype(np.float32)
    return HousingData(x=x, y=y[:, None].astype(np.float32))


def make_lm_data(
    n_sequences: int, seq_len: int, vocab_size: int, seed: int = 0
) -> np.ndarray:
    """(N, seq_len+1) int32 token ids, Zipf-ish marginal + local structure."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=(n_sequences, seq_len + 1), p=probs)
    # inject local bigram structure so next-token prediction is learnable
    for t in range(1, seq_len + 1):
        copy_mask = rng.random(n_sequences) < 0.3
        toks[copy_mask, t] = (toks[copy_mask, t - 1] + 1) % vocab_size
    return toks.astype(np.int32)


class LMDataIterator:
    """Batched (tokens, labels) iterator over a private token shard."""

    def __init__(self, tokens: np.ndarray, seed: int = 0):
        self._toks = tokens
        self._rng = np.random.default_rng(seed)

    def __call__(self, batch_size: int) -> dict:
        idx = self._rng.integers(0, self._toks.shape[0], size=batch_size)
        seqs = self._toks[idx]
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    @property
    def n_examples(self) -> int:
        """Number of sequences in the shard."""
        return int(self._toks.shape[0])
