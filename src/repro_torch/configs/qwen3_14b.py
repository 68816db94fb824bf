"""qwen3-14b [dense] — qk_norm, GQA.

[hf:Qwen/Qwen3-8B scaled to 14B dims]: 40L, d_model=5120, 40H (GQA kv=8),
head_dim=128, d_ff=17408, vocab=151936, qk-norm, no qkv bias.

A framework-free copy of ``repro/configs/qwen3_14b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "qwen3-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B (14B dims)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
