"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242]: 38L, d_model=2048, shared attn 32H (kv=32),
d_ff=8192 (shared block MLP), ssm_state=64.  The single shared transformer
block (tied weights) is applied every 6th layer; per-instance scale adapters
keep applications distinguishable (the paper uses LoRA adapters).

A framework-free copy of ``repro/configs/zamba2_1p2b.py`` (data only).
"""

from repro_torch.models.config import MAMBA, SHARED_ATTN, ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        layer_pattern=(MAMBA,) * 5 + (SHARED_ATTN,),
        ssm_state=64,
        ssm_head_dim=64,
        source="arXiv:2411.15242 (Zamba2)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
