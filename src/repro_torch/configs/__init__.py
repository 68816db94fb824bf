"""Architecture registry: the 10 assigned configs (plus the housing MLP and
fedlm-100m in their own modules).

The port of ``repro/configs/__init__.py``; the config modules are
framework-free copies of the reference's, with torch dtypes.

Usage:  ``from repro_torch.configs import get_config, ARCHITECTURES``
        ``cfg = get_config("qwen3-14b")`` / ``get_reduced("qwen3-14b")``.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
}

ARCHITECTURES = tuple(_MODULES)


def get_config(arch: str):
    """The full-size config of an assigned architecture."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHITECTURES}")
    return importlib.import_module(_MODULES[arch]).config()


def get_reduced(arch: str):
    """The smoke-scale variant of an assigned architecture (``reduce_config``)."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHITECTURES}")
    return importlib.import_module(_MODULES[arch]).reduced()


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------

INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

# archs with sub-quadratic attention that run long_500k
LONG_CONTEXT_ARCHS = ("mamba2-780m", "zamba2-1.2b", "gemma3-4b")


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) runs; returns (applicable, reason-if-not)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k KV requires sub-quadratic variant"
    return True, ""
