"""Model composition: segments of stacked layers, decoder-only, hybrid and
encoder-decoder, the embedding, the head and the LM loss.

The port of ``repro/models/transformer.py``.  The params tree has the
reference's structure leaf for leaf: ``"segments"`` is a list (one entry per
``plan_segments`` segment) of tuples (one dict per layer of the segment's
unit), and every leaf under it has a leading ``repeats`` axis, also when
``repeats == 1``; ``shared_block`` (zamba2's tied attention
block), ``encoder`` (whisper) and ``mtp`` (deepseek's multi-token
prediction, its ``layer`` with a leading axis of 1) are where the reference
has them.  So ``core/packing.build_manifest`` gives the reference's manifest
(names, shapes, dtypes, offsets) and weights carry across with
``core/packing.tree_from_numpy``.

Where the reference runs ``lax.scan`` over a segment's leading axis, the
port loops over it in Python, in the same layer order.  ``cfg.remat`` is not
acted on (it changes no number).

Every entry point takes the reference's ``policy=``
(``models/sharding.ShardingPolicy``), threaded to every layer as the
reference threads it: under an active policy the MoE takes the
expert-parallel path and a decode step the sequence-sharded ones
(``models/layers.py``); where the reference only constrains a layout
(``constrain``/``seq_constrain``, which change no value), the port does
nothing.

Every family of the reference trains and decodes: the dense decoder
(``ATTN``/``SWA``, with or without a modality ``frontend_proj``), MoE and
MLA with MTP, Mamba2, the Mamba2 + shared-attention hybrid and the
encoder-decoder.  A decode step takes the cache tree of ``models/kvcache.py``
and writes into it in place: each layer gets its stacked leaf's view
``leaf[r]``, so no step restacks the cache as the reference's scan does.

Public entry points:

* ``init_params(generator, cfg, device)`` / ``abstract_params(cfg)``
* ``encode(params, frames, cfg, policy=None)`` — the audio encoder over
  frame embeddings
* ``forward(params, tokens, cfg, ...)`` — train/prefill logits, or a decode
  step's with ``caches``
* ``decode_step(params, tokens, caches, decode_pos, cfg)`` — one serve step
* ``lm_loss(params, batch, cfg)`` — the causal LM objective (+ MoE aux,
  + MTP when configured)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import layers
from repro_torch.models.config import (
    ATTN, MAMBA, SHARED_ATTN, SWA, XATTN, LayerSpec, ModelConfig, Segment, plan_segments,
)
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.tree import tree_map

__all__ = ["init_params", "abstract_params", "encode", "forward", "decode_step", "lm_loss"]


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    """One layer's params for its spec: ``norm1``/``mamba`` (``MAMBA``), an
    ``adapter_scale`` (``SHARED_ATTN``: the weights are ``shared_block``'s),
    else ``norm1``, ``attn`` (GQA or MLA), ``norm_x``/``xattn`` (``XATTN``),
    ``norm2`` and ``moe`` or ``mlp``."""
    if spec.kind == MAMBA:
        return {"norm1": layers.init_norm(cfg), "mamba": layers.init_mamba(generator, cfg)}
    if spec.kind == SHARED_ATTN:
        return {"adapter_scale": torch.ones((cfg.d_model,), dtype=cfg.param_dtype)}
    p: dict[str, Any] = {"norm1": layers.init_norm(cfg)}
    if cfg.attn_impl == "mla":
        p["attn"] = layers.init_mla(generator, cfg)
    else:
        p["attn"] = layers.init_attention(generator, cfg)
    if spec.kind == XATTN:
        p["norm_x"] = layers.init_norm(cfg)
        p["xattn"] = layers.init_attention(generator, cfg)
    p["norm2"] = layers.init_norm(cfg)
    if spec.moe:
        p["moe"] = layers.init_moe(generator, cfg)
    elif cfg.d_ff > 0:
        p["mlp"] = layers.init_mlp(generator, cfg)
    return p


def _init_shared_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Zamba2's tied full-attention transformer block."""
    return {
        "norm1": layers.init_norm(cfg),
        "attn": layers.init_attention(generator, cfg),
        "norm2": layers.init_norm(cfg),
        "mlp": layers.init_mlp(generator, cfg),
    }


def _stack_init(generator: torch.Generator, cfg: ModelConfig, seg: Segment) -> tuple:
    """Stacked (repeats-leading) params for one segment: a tuple over the unit."""
    steps = [tuple(_init_layer(generator, cfg, s) for s in seg.unit)
             for _ in range(seg.repeats)]
    return tree_map(lambda *xs: torch.stack(xs), *steps)


def init_params(generator: torch.Generator, cfg: ModelConfig, device: torch.device | str):
    """Random init from ``generator`` (drawn on its device), then moved to ``device``.

    Embedding ``(Vp, D)`` at σ = 0.02, the router at 0.02, every projection
    at σ = 1/sqrt(fan_in) (Mamba2's conv at 0.2), truncated at ±2σ; norm
    scales and adapters 1, biases 0; Mamba2's ``A_log``, ``D_skip`` and
    ``dt_bias`` as the reference sets them.
    """
    return tree_map(lambda t: t.to(device), _init_tree(generator, cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """The tree :func:`init_params` returns, as ``meta`` tensors of the same
    names, shapes and dtypes: nothing is drawn or allocated (the reference's
    ``jax.eval_shape`` of its init; the dry-run's input)."""
    with torch.device("meta"):
        return _init_tree(None, cfg)


def _init_tree(generator: torch.Generator | None, cfg: ModelConfig) -> dict:
    """The params tree on the generator's device; with no generator, on the
    default device and undrawn (``layers._dense_init``)."""
    Vp, D = cfg.padded_vocab_size, cfg.d_model
    params: dict[str, Any] = {
        "embed": layers._dense_init(generator, (Vp, D), cfg.param_dtype, scale=0.02),
        "final_norm": layers.init_norm(cfg),
        "segments": [_stack_init(generator, cfg, seg) for seg in plan_segments(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers._dense_init(generator, (D, Vp), cfg.param_dtype)
    if any(s.kind == SHARED_ATTN for s in cfg.layer_specs()):
        params["shared_block"] = _init_shared_block(generator, cfg)
    if cfg.frontend is not None:
        params["frontend_proj"] = layers._dense_init(
            generator, (cfg.frontend_dim, D), cfg.param_dtype)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "segments": [_stack_init(generator, cfg, _encoder_segment(cfg))],
            "final_norm": layers.init_norm(cfg),
        }
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": layers._dense_init(generator, (2 * D, D), cfg.param_dtype),
            "norm_h": layers.init_norm(cfg),
            "norm_e": layers.init_norm(cfg),
            "layer": tree_map(lambda t: t[None],
                              _init_layer(generator, cfg, LayerSpec(kind=ATTN))),
            "final_norm": layers.init_norm(cfg),
        }
    return params


def _encoder_segment(cfg: ModelConfig) -> Segment:
    return Segment(unit=(LayerSpec(kind=ATTN),), repeats=cfg.n_encoder_layers)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, *,
                 positions: torch.Tensor, policy: ShardingPolicy | None = None,
                 shared_block: dict | None = None,
                 memory: torch.Tensor | None = None, cache: dict | None = None,
                 decode_pos: torch.Tensor | None = None, decode_masks: dict | None = None):
    """One layer; returns ``(x, aux)``, ``aux`` the MoE load-balance loss (0
    elsewhere).  With ``cache``, the layer's entry of the decode cache, one
    decode step at ``decode_pos`` that writes the entry in place (attention
    masks shared through the step's ``decode_masks``).

    ``SHARED_ATTN`` runs ``shared_block`` (causal attention scaled by the
    layer's ``adapter_scale``, then its MLP; the cache at this position holds
    its keys and values); ``MAMBA`` the Mamba2 mixer; the attention family
    pre-norm attention (sliding for ``SWA``, causal otherwise), cross-attention
    to ``memory`` for ``XATTN`` (recomputed from the memory at every step,
    never cached), then the MoE or the MLP.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == SHARED_ATTN:
        sb = shared_block
        h = layers.apply_norm(sb["norm1"], x, cfg)
        a, _ = layers.apply_attention(sb["attn"], h, cfg, positions=positions, mode="causal",
                                      policy=policy,
                                      kv_cache=None if cache is None else cache["attn"],
                                      decode_pos=decode_pos, decode_masks=decode_masks)
        x = x + a * p["adapter_scale"].to(x.dtype)
        h = layers.apply_norm(sb["norm2"], x, cfg)
        return x + layers.apply_mlp(sb["mlp"], h, cfg, policy), aux
    if spec.kind == MAMBA:
        h = layers.apply_norm(p["norm1"], x, cfg)
        y, _ = layers.apply_mamba(p["mamba"], h, cfg, policy=policy,
                                  cache=None if cache is None else cache["mamba"])
        return x + y, aux

    mode = "sliding" if spec.kind == SWA else "causal"
    h = layers.apply_norm(p["norm1"], x, cfg)
    attend = layers.apply_mla if cfg.attn_impl == "mla" else layers.apply_attention
    a, _ = attend(p["attn"], h, cfg, positions=positions, mode=mode, policy=policy,
                  kv_cache=None if cache is None else cache["attn"], decode_pos=decode_pos,
                  decode_masks=decode_masks)
    x = x + a
    if spec.kind == XATTN:
        h = layers.apply_norm(p["norm_x"], x, cfg)
        a, _ = layers.apply_attention(p["xattn"], h, cfg, positions=positions, mode="full",
                                      policy=policy, x_cross=memory)
        x = x + a
    h = layers.apply_norm(p["norm2"], x, cfg)
    if "moe" in p:
        y, aux = layers.apply_moe(p["moe"], h, cfg, policy)
        x = x + y
    elif "mlp" in p:
        x = x + layers.apply_mlp(p["mlp"], h, cfg, policy)
    return x, aux


def _run_segments(params_segments: list, x: torch.Tensor, cfg: ModelConfig,
                  segs: list[Segment], *, positions: torch.Tensor,
                  policy: ShardingPolicy | None = None, shared_block: dict | None = None,
                  memory: torch.Tensor | None = None, caches: list | None = None,
                  decode_pos: torch.Tensor | None = None, decode_masks: dict | None = None,
                  encoder: bool = False):
    """Apply every segment: for each step of its leading axis, its unit in
    order.  Returns ``(x, aux)``, the MoE aux summed over the layers.  With
    ``caches``, each layer gets its entry's views and writes them in place.

    With ``encoder=True`` every spec runs as ``ATTN``, hence with *causal*
    self-attention, as the reference's encoder does (its ``_encoder_mode``,
    which would make it bidirectional, is never called).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (seg, seg_params) in enumerate(zip(segs, params_segments)):
        for r in range(seg.repeats):
            p_unit = tree_map(lambda a: a[r], seg_params)
            c_unit = None if caches is None else tree_map(lambda a: a[r], caches[si])
            for li, spec in enumerate(seg.unit):
                if encoder:
                    spec = dataclasses.replace(spec, kind=ATTN)
                x, a = _apply_layer(p_unit[li], x, cfg, spec, positions=positions, policy=policy,
                                    shared_block=shared_block, memory=memory,
                                    cache=None if c_unit is None else c_unit[li],
                                    decode_pos=decode_pos, decode_masks=decode_masks)
                aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    # The whole table is cast before the gather, as in the reference.
    x = params["embed"].to(cfg.dtype)[tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype, device=x.device)
    if cfg.pos_embedding == "sinusoidal":
        x = x + layers.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
            policy: ShardingPolicy | None = None) -> torch.Tensor:
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
        mask = pad.float() * torch.full((), -1e30, dtype=torch.float32, device=x.device)
        logits = logits + mask.to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           policy: ShardingPolicy | None = None) -> torch.Tensor:
    """The audio encoder over stubbed (precomputed) frame embeddings
    ``(B, S_enc, frontend_dim)``: ``frontend_proj``, sinusoidal positions,
    the encoder's layers (causal, as in the reference) and its final norm."""
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = frames.to(cfg.dtype) @ params["frontend_proj"].to(cfg.dtype)
    x = x + layers.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    x, _ = _run_segments(enc["segments"], x, cfg, [_encoder_segment(cfg)],
                         positions=positions, policy=policy, encoder=True)
    return layers.apply_norm(enc["final_norm"], x, cfg)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            policy: ShardingPolicy | None = None,
            prefix_embeds: torch.Tensor | None = None, memory: torch.Tensor | None = None,
            frames: torch.Tensor | None = None, caches: list | None = None,
            decode_pos: int | torch.Tensor | None = None, return_hidden: bool = False):
    """Token logits for train/prefill, or for a decode step with ``caches``.

    ``tokens`` (B, S) of integers; ``prefix_embeds`` (B, n_pre,
    frontend_dim) are a VLM's patch embeddings, projected by
    ``frontend_proj`` and prepended (their positions come first; their logits
    are dropped).  An encoder-decoder takes the encoder's ``memory``, or
    ``frames`` to encode, and raises the reference's ``AssertionError`` with
    neither.

    Decode: ``caches`` is ``models/kvcache.py``'s tree and ``decode_pos`` the
    absolute position of the one token (a Python int or a 0-d tensor, never
    read back to the host); positions are ``decode_pos + arange(S)`` and
    every layer writes its state into ``caches`` in place.

    Returns ``(logits, caches, aux)`` as the reference does (``caches`` the
    same tree, or ``None`` without one; ``aux`` the MoE load-balance loss
    summed over the layers), plus the final hidden states before the final
    norm with ``return_hidden`` (the MTP head's input).
    """
    S = tokens.shape[1]
    if (caches is None) != (decode_pos is None) or (caches is not None and S != 1):
        raise ValueError("a decode step takes caches, decode_pos and one token a sequence; "
                         f"got {S} tokens, caches {'set' if caches is not None else None}, "
                         f"decode_pos {decode_pos}")
    if decode_pos is None:
        n_pre = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        positions = torch.arange(n_pre + S, device=tokens.device)[None, :]
    else:
        decode_pos = torch.as_tensor(decode_pos, dtype=torch.int64, device=tokens.device)
        positions = decode_pos + torch.arange(S, device=tokens.device)[None, :]

    x = _embed(params, tokens, cfg, positions[:, -S:])
    if prefix_embeds is not None:
        pre = prefix_embeds.to(cfg.dtype) @ params["frontend_proj"].to(cfg.dtype)
        x = torch.cat([pre, x.to(pre.dtype)], dim=1)

    if cfg.is_encoder_decoder and memory is None:
        if frames is None:
            raise AssertionError("enc-dec model needs frames or memory")
        memory = encode(params, frames, cfg, policy)

    x, aux = _run_segments(params["segments"], x, cfg, plan_segments(cfg), positions=positions,
                           policy=policy, shared_block=params.get("shared_block"), memory=memory,
                           caches=caches, decode_pos=decode_pos,
                           decode_masks=None if caches is None else {})

    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    logits = _logits(params, x, cfg, policy)
    if return_hidden:
        return logits, caches, aux, x
    return logits, caches, aux


def decode_step(params: dict, tokens: torch.Tensor, caches: list,
                decode_pos: int | torch.Tensor, cfg: ModelConfig, *,
                policy: ShardingPolicy | None = None, memory: torch.Tensor | None = None):
    """One serve step, under ``torch.no_grad()``: the next-token logits
    ``(B, 1, Vp)`` of ``tokens`` (B, 1) at position ``decode_pos``, and the
    caches (the same tree, updated in place)."""
    with torch.no_grad():
        logits, caches, _ = forward(params, tokens, cfg, policy=policy, memory=memory,
                                    caches=caches, decode_pos=decode_pos)
    return logits, caches


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0]
    return -ll.mean()


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: ShardingPolicy | None = None) -> torch.Tensor:
    """Causal LM loss: mean next-token cross-entropy in f32, plus
    ``router_aux_coef · aux`` with experts, plus deepseek's MTP term
    ``0.3 · xent`` of the token after next, predicted from
    ``[norm_h(h_t); norm_e(embed[label_t])] @ proj`` through one more layer.

    batch: ``{"tokens": (B, S), "labels": (B, S)}`` int64, plus an optional
    ``"prefix_embeds"`` (VLM) or ``"frames"`` (audio encoder-decoder).
    """
    logits, _, aux, h = forward(params, batch["tokens"], cfg, policy=policy,
                                prefix_embeds=batch.get("prefix_embeds"),
                                frames=batch.get("frames"), return_hidden=True)
    loss = _xent(logits, batch["labels"])
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux
    if cfg.mtp_depth > 0:
        mtp = params["mtp"]
        emb_next = params["embed"].to(cfg.dtype)[batch["labels"]]
        hcat = torch.cat([layers.apply_norm(mtp["norm_h"], h, cfg),
                          layers.apply_norm(mtp["norm_e"], emb_next, cfg)], dim=-1)
        h2 = hcat @ mtp["proj"].to(hcat.dtype)
        positions = torch.arange(batch["tokens"].shape[1], device=h2.device)[None, :]
        h2, _ = _apply_layer(tree_map(lambda a: a[0], mtp["layer"]), h2, cfg,
                             LayerSpec(kind=ATTN), positions=positions, policy=policy)
        h2 = layers.apply_norm(mtp["final_norm"], h2, cfg)
        logits2 = _logits(params, h2, cfg, policy)
        # position t predicts label t+1
        loss = loss + 0.3 * _xent(logits2[:, :-1], batch["labels"][:, 1:])
    return loss
