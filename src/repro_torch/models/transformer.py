"""The dense decoder: segments of stacked layers, embedding, head and LM loss.

The port of the dense family of ``repro/models/transformer.py``.  The params
tree has the reference's structure leaf for leaf: ``"segments"`` is a list
(one entry per ``plan_segments`` segment) of tuples (one dict per layer of
the segment's unit), and every leaf under it has a leading ``repeats`` axis,
also when ``repeats == 1``.  So ``core/packing.build_manifest`` gives the
reference's manifest (names, shapes, dtypes, offsets) and weights carry
across with ``core/packing.tree_from_numpy``.

Where the reference runs ``lax.scan`` over a segment's leading axis, the
port loops over it in Python, in the same layer order.  ``cfg.remat`` is not
acted on (it changes no number).

Public entry points:

* ``init_params(generator, cfg, device)``
* ``forward(params, tokens, cfg, ...)`` — train/prefill logits
* ``lm_loss(params, batch, cfg)`` — the causal LM objective

The dense family is the ``ATTN`` and ``SWA`` layer kinds with a dense MLP,
with or without a modality ``frontend_proj``.  MoE, MLA and multi-token
prediction are slice H-2; Mamba2, the shared-attention hybrid and the
encoder-decoder are H-3; decoding with a KV cache is H-4.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import layers
from repro_torch.models.config import (
    ATTN, SWA, LayerSpec, ModelConfig, Segment, plan_segments,
)
from repro_torch.tree import tree_map

__all__ = ["check_supported", "init_params", "forward", "lm_loss"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the port's slice that owes ``cfg``'s
    family (MoE, MLA, MTP: H-2; Mamba2, the hybrid, the encoder-decoder:
    H-3) unless it is the dense decoder family."""
    owed = None
    if cfg.n_experts or cfg.attn_impl == "mla" or cfg.mtp_depth:
        owed = "H-2"
    elif set(cfg.layer_pattern) - {ATTN, SWA} or cfg.is_encoder_decoder:
        owed = "H-3"
    if owed is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}): this model family is slice {owed} of the port "
            "(ROADMAP.md); the port trains the dense decoder family"
        )


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    """One dense layer's params: ``norm1``, ``attn``, ``norm2``, ``mlp``."""
    p: dict[str, Any] = {
        "norm1": layers.init_norm(cfg),
        "attn": layers.init_attention(generator, cfg),
        "norm2": layers.init_norm(cfg),
    }
    if cfg.d_ff > 0:
        p["mlp"] = layers.init_mlp(generator, cfg)
    return p


def _stack_init(generator: torch.Generator, cfg: ModelConfig, seg: Segment) -> tuple:
    """Stacked (repeats-leading) params for one segment: a tuple over the unit."""
    steps = [tuple(_init_layer(generator, cfg, s) for s in seg.unit)
             for _ in range(seg.repeats)]
    return tree_map(lambda *xs: torch.stack(xs), *steps)


def init_params(generator: torch.Generator, cfg: ModelConfig, device: torch.device | str):
    """Random init from ``generator`` (drawn on its device), then moved to ``device``.

    Embedding ``(Vp, D)`` at σ = 0.02, every projection at σ = 1/sqrt(fan_in),
    truncated at ±2σ; norm scales 1, biases 0.
    """
    check_supported(cfg)
    Vp, D = cfg.padded_vocab_size, cfg.d_model
    params: dict[str, Any] = {
        "embed": layers._dense_init(generator, (Vp, D), cfg.param_dtype, scale=0.02),
        "final_norm": layers.init_norm(cfg),
        "segments": [_stack_init(generator, cfg, seg) for seg in plan_segments(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers._dense_init(generator, (D, Vp), cfg.param_dtype)
    if cfg.frontend is not None:
        params["frontend_proj"] = layers._dense_init(
            generator, (cfg.frontend_dim, D), cfg.param_dtype)
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, *,
                 positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm attention (sliding for ``SWA``, causal otherwise), then the MLP."""
    mode = "sliding" if spec.kind == SWA else "causal"
    h = layers.apply_norm(p["norm1"], x, cfg)
    a, _ = layers.apply_attention(p["attn"], h, cfg, positions=positions, mode=mode)
    x = x + a
    h = layers.apply_norm(p["norm2"], x, cfg)
    if "mlp" in p:
        x = x + layers.apply_mlp(p["mlp"], h, cfg)
    return x


def _run_segments(params_segments: list, x: torch.Tensor, cfg: ModelConfig,
                  segs: list[Segment], *, positions: torch.Tensor) -> torch.Tensor:
    """Apply every segment: for each step of its leading axis, its unit in order."""
    for seg, seg_params in zip(segs, params_segments):
        for r in range(seg.repeats):
            p_unit = tree_map(lambda a: a[r], seg_params)
            for li, spec in enumerate(seg.unit):
                x = _apply_layer(p_unit[li], x, cfg, spec, positions=positions)
    return x


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    # The whole table is cast before the gather, as in the reference.
    x = params["embed"].to(cfg.dtype)[tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype, device=x.device)
    if cfg.pos_embedding == "sinusoidal":
        x = x + layers.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings or "lm_head" not in params:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    logits = x @ w
    # mask the padded vocabulary
    Vp, V = cfg.padded_vocab_size, cfg.vocab_size
    if Vp != V:
        pad = torch.arange(Vp, device=x.device) >= V
        mask = pad.float() * torch.tensor(-1e30, dtype=torch.float32, device=x.device)
        logits = logits + mask.to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds: torch.Tensor | None = None):
    """Token logits for train/prefill (decoding with a KV cache is slice H-4).

    ``tokens`` (B, S) int64; ``prefix_embeds`` (B, n_pre, frontend_dim) are
    a VLM's patch embeddings, projected by ``frontend_proj`` and prepended
    (their positions come first; their logits are dropped).  Returns
    ``(logits, None, aux)`` as the reference does (no caches; ``aux`` is the
    MoE auxiliary loss, 0 for the dense family).
    """
    check_supported(cfg)
    S = tokens.shape[1]
    n_pre = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    positions = torch.arange(n_pre + S, device=tokens.device)[None, :]

    x = _embed(params, tokens, cfg, positions[:, n_pre:])
    if prefix_embeds is not None:
        pre = prefix_embeds.to(cfg.dtype) @ params["frontend_proj"].to(cfg.dtype)
        x = torch.cat([pre, x.to(pre.dtype)], dim=1)

    x = _run_segments(params["segments"], x, cfg, plan_segments(cfg), positions=positions)

    if prefix_embeds is not None:
        x = x[:, n_pre:]
    logits = _logits(params, x, cfg)
    return logits, None, torch.zeros((), dtype=torch.float32, device=logits.device)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0]
    return -ll.mean()


def lm_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Causal LM loss: mean next-token cross-entropy in f32.

    batch: ``{"tokens": (B, S), "labels": (B, S)}`` int64, plus an optional
    ``"prefix_embeds"`` (VLM).
    """
    logits, _, _ = forward(params, batch["tokens"], cfg,
                           prefix_embeds=batch.get("prefix_embeds"))
    return _xent(logits, batch["labels"])
