"""fedlm-100m — the ~100M-parameter LM used by the end-to-end federated
training example (examples/fed_lm_e2e.py).  Not part of the assigned-arch
registry; CPU-trainable in minutes.

A framework-free copy of ``repro/configs/fedlm_100m.py`` (data only).
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "fedlm-100m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=8,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2304,
        vocab_size=24576,
        tie_embeddings=True,
        remat=False,
        source="(this repo: e2e example config)",
    )
