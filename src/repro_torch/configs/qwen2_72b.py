"""qwen2-72b [dense] — GQA with QKV bias.

[arXiv:2407.10671]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064.

A framework-free copy of ``repro/configs/qwen2_72b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "qwen2-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671 (Qwen2)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
