"""Decode cache construction, aligned with the scan segments.

The port of ``repro/models/kvcache.py``.  The cache tree mirrors
``plan_segments(cfg)``: a list over segments, each a tuple over unit
positions, each a dict holding that layer kind's state stacked over the
segment's ``repeats``:

* attention (``attn``/``swa``/``shared_attn``/``xattn``): ``{"attn": {"k","v"}}``
  of shape ``(repeats, B, L, KVH, hd)`` — ``L = min(sliding_window, max_len)``
  for ``swa`` layers (a ring buffer once ``max_len`` passes the window),
  ``max_len`` otherwise;
* MLA: ``{"attn": {"ckv","kpe"}}`` — the compressed latent cache,
  ``(repeats, B, L, kv_lora_rank)`` / ``(repeats, B, L, rope_dim)``;
* Mamba2: ``{"mamba": {"conv","ssm"}}`` — constant-size state, independent of
  ``max_len``; ``ssm`` is always float32.

The decode step writes into these tensors in place (``models/layers.py``), so
one cache serves a whole generation without a copy per step.
``abstract_cache`` returns the same tree on the ``meta`` device: shapes and
dtypes, no storage.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import MAMBA, SWA, LayerSpec, ModelConfig, plan_segments
from repro_torch.tree import flatten, tree_map

__all__ = ["init_cache", "abstract_cache", "cache_bytes"]


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _entry(cfg: ModelConfig, spec: LayerSpec, repeats: int, batch: int, max_len: int,
           dtype: torch.dtype) -> dict:
    """One unit position's cache entry, stacked over ``repeats``, on ``meta``."""
    if spec.kind == MAMBA:
        di, N = cfg.d_inner, cfg.ssm_state
        return {"mamba": {
            "conv": _meta((repeats, batch, cfg.conv_width - 1, di + 2 * N), dtype),
            "ssm": _meta((repeats, batch, cfg.ssm_heads, cfg.ssm_head_dim, N), torch.float32),
        }}
    L = min(cfg.sliding_window, max_len) if spec.kind == SWA else max_len
    if cfg.attn_impl == "mla":
        return {"attn": {
            "ckv": _meta((repeats, batch, L, cfg.kv_lora_rank), dtype),
            "kpe": _meta((repeats, batch, L, cfg.qk_rope_head_dim), dtype),
        }}
    kv = (repeats, batch, L, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"attn": {"k": _meta(kv, dtype), "v": _meta(kv, dtype)}}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list:
    """The cache tree as ``meta`` tensors (shapes and dtypes, no allocation)."""
    return [tuple(_entry(cfg, spec, seg.repeats, batch, max_len, dtype) for spec in seg.unit)
            for seg in plan_segments(cfg)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> list:
    """Zero-initialized cache on ``device`` (the card unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                    abstract_cache(cfg, batch, max_len, dtype))


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes the cache of ``init_cache`` holds."""
    return sum(t.numel() * t.element_size()
               for t in flatten(abstract_cache(cfg, batch, max_len, dtype))[0])
