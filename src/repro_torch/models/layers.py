"""Model building blocks of the dense decoder: norms, RoPE, GQA attention, MLP.

The port of the dense part of ``repro/models/layers.py``.  Pure functions
over parameter dicts of tensors (no ``nn.Module`` state, no in-place writes
to parameters), so ``torch.func.grad_and_value`` differentiates a loss built
from them.  Every block has an ``init_*`` (from an explicit
``torch.Generator``) and an apply function that follows the reference's
numerics:

* norms take their statistics **and** apply in f32, then cast back;
* RoPE rotates split halves (not interleaved pairs), angles in f32;
* attention scores are f32 products of the (upcast) q and k, the additive
  mask is ``-1e30`` in f32, the probabilities are cast back to q's dtype
  before the PV product;
* the plain (ungated) MLP uses GELU's tanh approximation, as
  ``jax.nn.gelu`` does by default.

Attention is plain torch arithmetic, as it is jnp in the reference (no
Pallas kernel there).  The decode path (KV cache, flash decode) is slice H-4;
MLA and MoE are H-2; Mamba2 is H-3.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = [
    "init_norm", "apply_norm", "rope_freqs", "apply_rope", "sinusoidal_embedding",
    "init_attention", "apply_attention", "init_mlp", "apply_mlp",
]

_NEG = -1e30  # the reference's additive mask value

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
# Standard-normal CDF at -2 and 2: the uniform range whose inverse CDF is the
# normal truncated to [-2, 2] (what ``jax.random.truncated_normal`` samples).
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))


def _dense_init(generator: torch.Generator, shape: tuple[int, ...], param_dtype,
                scale: float | None = None) -> torch.Tensor:
    """Truncated normal at ±2σ, σ = ``scale`` or ``1/sqrt(fan_in)``.

    Drawn on the generator's device.  The same distribution as the
    reference's, not the same numbers (a torch generator is not threefry):
    tests carry the reference's weights across instead.
    """
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (_CDF_HI - _CDF_LO) + _CDF_LO
    x = (torch.erfinv(2.0 * u - 1.0) * _SQRT2).clamp_(-2.0, 2.0)
    return (x * std).to(param_dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int | None = None) -> dict:
    """``{"scale"}`` of ones (plus a zero ``"bias"`` for LayerNorm)."""
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.param_dtype)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype)
    return p


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis: f32 statistics and apply."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def _rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary / sinusoidal position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i/head_dim)`` for ``i < head_dim/2``, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings, (..., S, D), f32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, sliding window, qk-norm, optional bias)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo`` (+ ``b*`` with qkv bias, + qk-norm scales)."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _dense_init(generator, (D, H * hd), cfg.param_dtype),
        "wk": _dense_init(generator, (D, KVH * hd), cfg.param_dtype),
        "wv": _dense_init(generator, (D, KVH * hd), cfg.param_dtype),
        "wo": _dense_init(generator, (H * hd, D), cfg.param_dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=cfg.param_dtype)
        p["bk"] = torch.zeros((KVH * hd,), dtype=cfg.param_dtype)
        p["bv"] = torch.zeros((KVH * hd,), dtype=cfg.param_dtype)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.param_dtype)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.param_dtype)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(*q.shape[:-1], H, hd)
    k = k.reshape(*k.shape[:-1], KVH, hd)
    v = v.reshape(*v.shape[:-1], KVH, hd)
    if cfg.qk_norm:
        q = _rms_head_norm(p["q_norm"], q)
        k = _rms_head_norm(p["k_norm"], k)
    return q, k, v


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat each KV head ``n_rep`` times along the head axis (``jnp.repeat``)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def _attn_mask(q_len: int, k_len: int, q_offset: int, mode: str, window: int,
               device=None) -> torch.Tensor:
    """(q_len, k_len) additive f32 mask: 0 where a query may see a key, -1e30
    elsewhere.  ``mode`` is ``"causal"``, ``"sliding"`` or ``"full"``."""
    if mode == "full":
        return torch.zeros((q_len, k_len), dtype=torch.float32, device=device)
    qi = q_offset + torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(k_len, device=device)[None, :]
    ok = kj <= qi
    if mode == "sliding":
        ok = ok & (kj > qi - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full((), _NEG, dtype=torch.float32, device=device))


def _sdpa_naive(q, k, v, mask, *, scale: float) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) v with the full score tensor.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd).  Scores are f32 products of
    the upcast inputs (the reference's ``preferred_element_type=f32``); the
    probabilities are cast back to q's dtype for the PV product.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * scale + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_chunked(q, k, v, *, scale: float, mode: str, window: int, q_offset: int,
                  chunk: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` keys.

    The reference's ``lax.scan`` over chunks becomes a Python loop: per
    chunk, the f32 scores ``(B, H, Sq, chunk)``, the running max ``m``, the
    running denominator ``l`` and the f32 accumulator.  Equal to the naive
    path to float rounding.
    """
    B, Sq, H, hd = q.shape
    hd_v = v.shape[-1]
    Sk = k.shape[1]
    nchunks = (Sk + chunk - 1) // chunk
    pad = nchunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qi = q_offset + torch.arange(Sq, device=q.device)[:, None]  # absolute q positions
    qf = q.float()
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd_v), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        kj = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        ok = kj < Sk  # mask padding
        if mode != "full":
            ok = ok & (kj <= qi)
        if mode == "sliding":
            ok = ok & (kj > qi - window)
        s = torch.where(ok[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype), vb)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd_v)


def _use_chunked(cfg: ModelConfig, q_len: int, k_len: int) -> bool:
    """The reference's choice: chunked from ``attn_chunk_min_len`` keys on,
    unless ``attn_naive`` or a single query."""
    return not cfg.attn_naive and q_len > 1 and k_len >= cfg.attn_chunk_min_len


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                    mode: str, kv_cache=None) -> tuple[torch.Tensor, None]:
    """Self-attention over the whole sequence (train and prefill).

    ``mode`` is ``"causal"``, ``"sliding"`` or ``"full"``.  Returns
    ``(y, None)``: the second item is the reference's updated cache, which
    the train/prefill branch does not produce.
    """
    if kv_cache is not None:
        raise NotImplementedError("decode with a KV cache is slice H-4 of the port")
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    n_rep = H // KVH
    B = x.shape[0]

    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    if _use_chunked(cfg, q.shape[1], k.shape[1]):
        out = _sdpa_chunked(q, k, v, scale=scale, mode=mode, window=cfg.sliding_window,
                            q_offset=0, chunk=cfg.attn_k_chunk)
    else:
        mask = _attn_mask(q.shape[1], k.shape[1], 0, mode, cfg.sliding_window, x.device)
        out = _sdpa_naive(q, k, v, mask, scale=scale)
    out = out.reshape(B, -1, H * hd)
    return out @ p["wo"].to(out.dtype), None


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """SiLU-gated ``w_gate``/``w_up``/``w_down``, or plain ``w_up``/``w_down``
    with biases."""
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_gated:
        return {
            "w_gate": _dense_init(generator, (D, Fd), cfg.param_dtype),
            "w_up": _dense_init(generator, (D, Fd), cfg.param_dtype),
            "w_down": _dense_init(generator, (Fd, D), cfg.param_dtype),
        }
    return {
        "w_up": _dense_init(generator, (D, Fd), cfg.param_dtype),
        "w_down": _dense_init(generator, (Fd, D), cfg.param_dtype),
        "b_up": torch.zeros((Fd,), dtype=cfg.param_dtype),
        "b_down": torch.zeros((D,), dtype=cfg.param_dtype),
    }


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``w_down(silu(x w_gate) * x w_up)``, or ``w_down(gelu_tanh(x w_up + b))``."""
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype), approximate="tanh")
    y = h @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        y = y + p["b_down"].to(y.dtype)
    return y
