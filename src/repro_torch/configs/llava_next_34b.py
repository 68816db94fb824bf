"""llava-next-34b [vlm] — anyres tiling VLM backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] scaled to the 34B variant's LM
backbone: 60L, d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000.
The vision tower (SigLIP/CLIP ViT + anyres tile packing) is a STUB per the
assignment carve-out: ``input_specs`` supplies precomputed patch embeddings
(one base tile, 576 patches of dim 1152) which ``frontend_proj`` maps into
the LM embedding space and prepends to the text sequence.

A framework-free copy of ``repro/configs/llava_next_34b.py`` (data only).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.configs.common import reduce_config

ARCH_ID = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        frontend="vision_stub",
        frontend_dim=1152,
        num_prefix_tokens=576,  # one anyres base tile (24x24 patches)
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B backbone dims)",
    )


def reduced() -> ModelConfig:
    return reduce_config(config())
