"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k.

[hf:google/gemma-3-1b-pt scaled to 4B dims]: 34L, d_model=2560, 8H (GQA
kv=4), head_dim=256, d_ff=10240, vocab=262144, sliding_window=1024,
qk-norm, tied embeddings, embeddings scaled by sqrt(d_model).
Deviation: a single rope_theta is used for local and
global layers (upstream uses 10k local / 1M global).

A framework-free copy of ``repro/configs/gemma3_4b.py`` (data only).
"""

from repro_torch.models.config import ATTN, SWA, ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        qk_norm=True,
        sliding_window=1024,
        layer_pattern=(SWA, SWA, SWA, SWA, SWA, ATTN),
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt (4B dims)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
