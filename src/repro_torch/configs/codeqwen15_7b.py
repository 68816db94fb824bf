"""codeqwen1.5-7b [dense] — Qwen1.5 architecture (QKV bias, MHA kv=32).

[hf:Qwen/CodeQwen1.5-7B]: 32L, d_model=4096, 32H (GQA kv=32 -> full MHA),
d_ff=13440, vocab=92416.

A framework-free copy of ``repro/configs/codeqwen15_7b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/CodeQwen1.5-7B",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
