"""Step-function builders: train_step, prefill_step and serve_step per config.

The port of ``repro/launch/steps.py``.  Each step is a function of
``(params, ...)`` over the functional model of ``models/transformer.py``,
under the sharding ``policy`` given (``models/sharding.ShardingPolicy``; none
by default).
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.optim import Optimizer

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    policy: ShardingPolicy | None = None):
    """``(params, opt_state, batch) -> (params, opt_state, loss)``: one optimizer
    step on the gradient of ``lm_loss``."""
    grad_and_value = torch.func.grad_and_value(
        lambda params, batch: transformer.lm_loss(params, batch, cfg, policy=policy))

    def train_step(params, opt_state, batch):
        grads, loss = grad_and_value(params, batch)
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, policy: ShardingPolicy | None = None):
    """``(params, batch) -> next_tokens``: the full forward (a VLM's
    ``prefix_embeds``, an encoder-decoder's ``frames``), then the greedy next
    token of every sequence as int32 (``(B,)``)."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _, _ = transformer.forward(
                params, batch["tokens"], cfg, policy=policy,
                prefix_embeds=batch.get("prefix_embeds"), frames=batch.get("frames"))
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return prefill_step


def make_serve_step(cfg: ModelConfig, policy: ShardingPolicy | None = None):
    """``(params, caches, tokens (B, 1), pos, memory=None) -> (next (B, 1)
    int32, caches)``: one decode step (the caches updated in place), then the
    greedy next token over the padded vocabulary's logits; of equal maxima
    the first wins, as in ``jnp.argmax``."""

    def serve_step(params, caches, tokens, pos, memory=None):
        logits, caches = transformer.decode_step(params, tokens, caches, pos, cfg,
                                                 policy=policy, memory=memory)
        return torch.argmax(logits[:, -1, :], dim=-1, keepdim=True).to(torch.int32), caches

    return serve_step
