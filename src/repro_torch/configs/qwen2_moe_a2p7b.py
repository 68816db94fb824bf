"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L, d_model=2048, 16H (kv=16),
moe_d_ff=1408, vocab=151936.  60 routed experts are padded to 64 for
expert-sharding divisibility over the 16-way model axis;
the 4 pad experts receive -inf router logits and are never selected.
Shared-expert intermediate = 5632 (4 x 1408).

A framework-free copy of ``repro/configs/qwen2_moe_a2p7b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        qkv_bias=True,
        n_experts=60,
        expert_pad_to=64,
        n_shared_experts=4,
        shared_d_ff=5632,
        top_k=4,
        moe_d_ff=1408,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
