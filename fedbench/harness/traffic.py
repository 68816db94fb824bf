"""The one traffic generator: every learner's token shard and batches from
the seed and a mix's parameters.

Tokens follow a Zipf marginal (``p(rank) ∝ rank^-zipf_exponent``) with
local structure: with probability ``copy_prob`` a token is its predecessor
plus one, so next-token prediction is learnable and the loss falls (the
statistics of the port's ``data/synthetic.make_lm_data``, drawn here on the
device in a few large calls).  Learner ``i`` holds ``seqs_per_learner``
sequences of ``seq_len + 1`` tokens and a held-out eval set of
``eval_seqs``; its ``k``-th training batch is ``batch_seqs`` sequences in
the order of a per-learner permutation, so every seed gives every learner the
same sizes and a batch depends only on ``(seed, learner, k)``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Shards:
    """Every learner's tokens and batch order, on the device."""

    train: list[torch.Tensor]  # (seqs_per_learner, seq_len + 1) int64 each
    evals: list[torch.Tensor]  # (eval_seqs, seq_len + 1) int64 each
    order: list[torch.Tensor]  # a permutation of the train rows each
    batch_seqs: int

    def batch(self, learner: int, k: int) -> dict:
        """Learner ``learner``'s ``k``-th training batch (0-based)."""
        rows = self.train[learner].shape[0]
        per_epoch = rows // self.batch_seqs
        j = (k % per_epoch) * self.batch_seqs
        seqs = self.train[learner][self.order[learner][j: j + self.batch_seqs]]
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def eval_batch(self, learner: int, start: int = 0, stop: int | None = None) -> dict:
        """Rows ``start:stop`` of learner ``learner``'s eval set."""
        seqs = self.evals[learner][start:stop]
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def data_generator(seed: int, device: torch.device) -> torch.Generator:
    """The data's own stream, apart from the weights'."""
    return torch.Generator(device=device).manual_seed((int(seed) * 2 + 1) % (2 ** 63))


def _tokens(gen: torch.Generator, n: int, length: int, vocab: int, zipf: float,
            copy_prob: float, device: torch.device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -zipf, 0)
    cdf = (cdf / cdf[-1]).to(torch.float32)
    u = torch.rand((n, length), generator=gen, device=device)
    base = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    copy = torch.rand((n, length), generator=gen, device=device) < copy_prob
    copy[:, 0] = False
    pos = torch.arange(length, device=device).expand(n, length)
    start = torch.where(copy, torch.zeros_like(pos), pos).cummax(dim=1).values
    return (torch.gather(base, 1, start) + (pos - start)) % vocab


def make_shards(traffic: dict, vocab: int, seed: int, device: torch.device) -> Shards:
    """Every learner's shard, eval set and batch order for ``traffic``."""
    gen = data_generator(seed, device)
    n_l = traffic["learners"]
    per, ev = traffic["seqs_per_learner"], traffic["eval_seqs"]
    length = traffic["seq_len"] + 1
    if per % traffic["batch_seqs"]:
        raise ValueError("seqs_per_learner must be a whole number of batches")
    toks = _tokens(gen, n_l * (per + ev), length, vocab, traffic["zipf_exponent"],
                   traffic["copy_prob"], device).reshape(n_l, per + ev, length)
    order = [torch.randperm(per, generator=gen, device=device) for _ in range(n_l)]
    return Shards(train=[t[:per] for t in toks], evals=[t[per:] for t in toks],
                  order=order, batch_seqs=traffic["batch_seqs"])
