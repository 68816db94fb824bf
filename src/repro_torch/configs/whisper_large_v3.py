"""whisper-large-v3 [audio] — encoder-decoder with stubbed conv frontend.

[arXiv:2212.04356]: 32 encoder + 32 decoder layers, d_model=1280, 20H
(kv=20), d_ff=5120 (plain GELU MLP), vocab=51866 (padded to 51968),
LayerNorm, absolute sinusoidal positions, 1500 encoder frames.  The
mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: ``input_specs`` supplies precomputed frame embeddings.
Decode shapes exercise the *decoder* serve step; 32k decode positions
exceed Whisper's trained 448-token context and are a stress shape only.

A framework-free copy of ``repro/configs/whisper_large_v3.py`` (data only).
"""

from repro_torch.models.config import ATTN, XATTN, ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        n_layers=32,  # decoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        layer_pattern=(XATTN,),
        is_encoder_decoder=True,
        n_encoder_layers=32,
        encoder_seq_len=1500,
        frontend="audio_stub",
        frontend_dim=1280,
        mlp_gated=False,
        norm_type="layernorm",
        pos_embedding="sinusoidal",
        source="arXiv:2212.04356 (Whisper; large-v3 dims)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
