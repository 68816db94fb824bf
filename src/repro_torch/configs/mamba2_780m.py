"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060]: 48L, d_model=1536 (d_inner=3072, 48 ssm heads of 64),
ssm_state=128, vocab=50280 (padded to 50432), no MLP (d_ff=0).

A framework-free copy of ``repro/configs/mamba2_780m.py`` (data only).
"""

from repro_torch.models.config import MAMBA, ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "mamba2-780m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=24,  # unused (attention-free); kept for completeness
        n_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        layer_pattern=(MAMBA,),
        ssm_state=128,
        ssm_head_dim=64,
        tie_embeddings=True,
        source="arXiv:2405.21060 (Mamba2)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
