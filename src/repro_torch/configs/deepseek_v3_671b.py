"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437]: 61L, d_model=7168, 128H MLA (q_lora=1536, kv_lora=512,
nope=128, rope=64, v=128), moe_d_ff=2048, vocab=129280, first 3 layers dense
(d_ff=18432), multi-token-prediction depth 1.

A framework-free copy of ``repro/configs/deepseek_v3_671b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,  # dense layers (first_k_dense)
        vocab_size=129280,
        attn_impl="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=256,
        n_shared_experts=1,
        shared_d_ff=2048,
        top_k=8,
        moe_d_ff=2048,
        first_k_dense=3,
        mtp_depth=1,
        source="arXiv:2412.19437 (DeepSeek-V3)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
