"""Shared helpers for architecture configs.

A framework-free copy of ``repro/configs/common.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["reduce_config"]


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family, tiny dimensions.

    2 pattern-cycles of layers (so heterogeneous patterns keep their
    structure), d_model<=256, <=4 experts, small vocab.
    """
    pat = len(cfg.layer_pattern)
    n_layers = max(2, pat) if pat > 1 else 2
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=min(cfg.d_model, 256),
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_to=128,
        sliding_window=min(cfg.sliding_window, 16),
        remat=False,
    )
    if cfg.n_experts:
        changes.update(
            n_experts=4, top_k=2, moe_d_ff=128,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            shared_d_ff=128 if cfg.n_shared_experts else 0,
            expert_pad_to=1, first_k_dense=min(cfg.first_k_dense, 1),
        )
    if cfg.attn_impl == "mla":
        changes.update(
            q_lora_rank=48, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.is_encoder_decoder:
        changes.update(n_encoder_layers=2, encoder_seq_len=24)
    if cfg.frontend:
        changes.update(frontend_dim=64, num_prefix_tokens=8)
    if cfg.mtp_depth:
        changes.update(mtp_depth=1)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
