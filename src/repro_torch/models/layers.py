"""Model building blocks: norms, RoPE, attention (GQA, sliding, cross, MLA),
MLP, MoE and Mamba2 (SSD).

The port of ``repro/models/layers.py``.  Pure functions over parameter dicts
of tensors (no ``nn.Module`` state, no in-place writes to parameters), so
``torch.func.grad_and_value`` differentiates a loss built from them.  Every
block has an ``init_*`` (from an explicit ``torch.Generator``) and an apply
function that follows the reference's numerics:

* norms take their statistics **and** apply in f32, then cast back;
* RoPE rotates split halves (not interleaved pairs), angles in f32;
* attention scores are f32 products of the (upcast) q and k, the additive
  mask is ``-1e30`` in f32, the probabilities are cast back to q's dtype
  before the PV product;
* the plain (ungated) MLP uses GELU's tanh approximation, as
  ``jax.nn.gelu`` does by default;
* the MoE router multiplies in f32 and takes the top k by a stable
  descending sort (``lax.top_k``'s order: ties to the lower index); every
  expert runs on every token, as in the reference's ``apply_moe_dense``;
* Mamba2's SSD, its causal conv and its gated norm run in f32.

Decode paths take a cache entry (``models/kvcache.py`` defines the layout)
and one token a step.  Where the reference returns a new cache from each
``dynamic_update_slice``, the port writes the step's keys and values (MLA's
latent, Mamba2's conv window and state) into the cache's own tensors with
``index_copy_``/``copy_`` and returns the same entry: a ``(repeats, ...)``
leaf passed down as ``leaf[r]`` is a view, so a step costs no copy of the
cache.  The decode attention is the naive one (one query), its validity
mask additive ``-1e30`` in f32 over the cache's slots.

Everything here is plain torch arithmetic, as it is jnp in the reference (no
Pallas kernel there).

The model axis: every apply function takes the reference's ``policy=``
(``models/sharding.ShardingPolicy``).  Where the reference only constrains
a layout under it, the port does nothing.  Under an active policy three
paths of the reference's run once a slot of the policy's mesh, their
collectives as ``models/sharding`` stands them in: ``_flash_decode``
(decode over a cache sharded along its length), MLA's absorbed decode over
a sharded latent cache, and the expert-parallel MoE ``apply_moe_ep``, with
its capacity-dropping dispatch body and its weights-stationary 2-D decode
body.  Without a policy, or with an inactive one, every function takes its
one-device path.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPolicy

__all__ = [
    "init_norm", "apply_norm", "rope_freqs", "apply_rope", "sinusoidal_embedding",
    "init_attention", "apply_attention", "init_mla", "apply_mla", "init_mlp", "apply_mlp",
    "init_moe", "moe_aux_loss", "apply_moe_dense", "apply_moe_ep", "moe_ep_kept", "apply_moe",
    "init_mamba", "apply_mamba",
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
    tests carry the reference's weights across instead.  With no generator,
    an uninitialized tensor on the default device, nothing drawn
    (``transformer.abstract_params`` builds its ``meta`` tree this way).
    """
    if generator is None:
        return torch.empty(shape, dtype=param_dtype)
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


@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i/head_dim)`` for ``i < head_dim/2``, f32.  Built once
    per (head dim, theta, device) and shared, never written: every layer of
    every step reads the same table, with no host-to-device copy."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


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
# attention (GQA, sliding window, qk-norm, optional bias, cross-attention)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo`` (+ ``b*`` with qkv bias, + qk-norm scales).

    Cross-attention (whisper's ``xattn``) has the same leaves.
    """
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


def _project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    """Queries from ``xq``, keys and values from ``xkv`` (``xq`` itself, or
    the encoder's memory for cross-attention)."""
    hd = cfg.resolved_head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    q = xq @ p["wq"].to(xq.dtype)
    k = xkv @ p["wk"].to(xkv.dtype)
    v = xkv @ p["wv"].to(xkv.dtype)
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


def _sdpa_naive(q, k, v, mask, policy: ShardingPolicy | None = None, *,
                scale: float) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) v with the full score tensor.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd).  Scores are f32 products of
    the upcast inputs (the reference's ``preferred_element_type=f32``); the
    probabilities are cast back to q's dtype for the PV product.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * scale + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_chunked(q, k, v, policy: ShardingPolicy | None = None, *, scale: float, mode: str,
                  window: int, q_offset: int, chunk: int) -> torch.Tensor:
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


def _sdpa(q, k, v, cfg: ModelConfig, *, mode: str, window: int = 0,
          policy: ShardingPolicy | None = None) -> torch.Tensor:
    """Chunked or naive attention, as the reference's ``_sdpa`` chooses, at
    the scale ``1/sqrt(q's head dim)``; ``v``'s head dim may differ (MLA)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if _use_chunked(cfg, q.shape[1], k.shape[1]):
        return _sdpa_chunked(q, k, v, policy, scale=scale, mode=mode, window=window,
                             q_offset=0, chunk=cfg.attn_k_chunk)
    mask = _attn_mask(q.shape[1], k.shape[1], 0, mode, window, q.device)
    return _sdpa_naive(q, k, v, mask, policy, scale=scale)


def _ring_positions(slots: torch.Tensor, pos: torch.Tensor, L: int) -> torch.Tensor:
    """Absolute position currently stored in each ring-buffer slot.

    The slot for absolute position t is t % L; slot j currently holds the
    largest t' <= pos with t' % L == j (negative before the ring is full).
    """
    base = pos - torch.remainder(pos, L)
    cand = base + slots
    return torch.where(cand <= pos, cand, cand - L)


def _decode_mask(L: int, pos: torch.Tensor, ring: bool) -> torch.Tensor:
    """(1, L) additive f32 mask over a cache's slots at decode position
    ``pos``: 0 for a written slot the query may see, -1e30 elsewhere.  A ring
    (a sliding layer whose cache holds exactly its window) sees the slots
    whose position is less than ``L`` old; a linear cache sees slots up to
    ``pos``."""
    kj = torch.arange(L, device=pos.device)
    if ring:
        rpos = _ring_positions(kj, pos, L)
        age = pos - rpos
        valid = (age >= 0) & (age < L) & (rpos >= 0)
    else:
        valid = kj <= pos
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(valid, zero, torch.full((), _NEG, device=pos.device))[None, :]


def _step_mask(masks: dict | None, L: int, pos: torch.Tensor, ring: bool) -> torch.Tensor:
    """:func:`_decode_mask`, built once per ``(L, ring)`` in a decode step's
    ``masks`` (shared by every layer of the step) or afresh without one."""
    if masks is None:
        return _decode_mask(L, pos, ring)
    if (L, ring) not in masks:
        masks[L, ring] = _decode_mask(L, pos, ring)
    return masks[L, ring]


def _slot(pos: torch.Tensor) -> torch.Tensor:
    """A 0-d position as the one-element int64 index ``index_copy_`` takes."""
    return pos.reshape(1).to(torch.int64)


def _seq_sharded(policy: ShardingPolicy | None, L: int) -> bool:
    """The reference's condition for a sequence-sharded decode over a cache
    of ``L`` slots: an active policy whose model axis divides ``L``."""
    return policy is not None and policy.active and L % policy.model_size == 0


def _shard_slots(masks: dict | None, L: int, pos: torch.Tensor, ring: bool,
                 msize: int) -> tuple[torch.Tensor, list]:
    """What every model slot of a sequence-sharded decode needs from the
    step's position, built once a step in its ``masks`` (or afresh without):
    the validity of each of the cache's ``L`` global slots (``kj <= pos``,
    or on a ring ``_ring_positions`` no more than ``L - 1`` old), and for
    each model slot ``m``, owning global slots ``[m·L/msize, (m+1)·L/msize)``,
    the clipped local index of the step's slot (``pos``, or ``pos % L`` on a
    ring) and whether it lies in ``m``'s window."""
    key = ("sharded", L, ring, msize)
    if masks is not None and key in masks:
        return masks[key]
    kj = torch.arange(L, device=pos.device)
    if ring:
        rpos = _ring_positions(kj, pos, L)
        valid = (pos - rpos >= 0) & (pos - rpos < L) & (rpos >= 0)
    else:
        valid = kj <= pos
    slot_g = torch.remainder(pos, L) if ring else pos
    L_loc = L // msize
    slots = []
    for m in range(msize):
        local = slot_g - m * L_loc
        slots.append((torch.clamp(local, 0, L_loc - 1).reshape(1).to(torch.int64),
                      (local >= 0) & (local < L_loc)))
    out = (valid, slots)
    if masks is not None:
        masks[key] = out
    return out


def _data_blocks(B: int, dsize: int) -> list[tuple[int, int]]:
    """Each data slot's rows ``[b0, b1)`` of a batch of ``B``: the reference
    shards the batch over the data axes where they divide it (and it is at
    least as large), and replicates it otherwise, when one block does."""
    if B % dsize == 0 and B >= dsize:
        step = B // dsize
        return [(d * step, (d + 1) * step) for d in range(dsize)]
    return [(0, B)]


def _write_window(window: torch.Tensor, idx: torch.Tensor, in_range: torch.Tensor,
                  new: torch.Tensor) -> None:
    """A slot's in-place cache update: its window's slot ``idx`` takes
    ``new`` where the step's slot lies in the window and keeps its value
    elsewhere (the reference's ``where(in_range, new, cur)`` update)."""
    cur = window.index_select(1, idx)
    window.index_copy_(1, idx, torch.where(in_range, new.to(window.dtype), cur))


def _slot_device(grid, d: int, m: int, cache: torch.Tensor) -> torch.device:
    """Slot ``(d, m)``'s device, which must hold the cache its window views:
    caches are not placed per slot, so a slot computes where the cache lies."""
    dev = grid[d, m]
    if cache.device != dev:
        raise ValueError(f"the cache lies on {cache.device} and slot ({d}, {m}) on {dev}: "
                         "a sequence-sharded decode runs its slots where the cache lies")
    return dev


def _flash_merge(scores: list, values: list, spec: str, dtype: torch.dtype,
                 home: torch.device) -> torch.Tensor:
    """The merge of the slots' partial attention (the reference's collectives
    after its per-shard scores): the ``pmax`` of the slots' maxima, each
    slot's ``exp(s - max)``, the ``psum`` of their sums and of ``exp`` (cast
    to ``dtype``) times the slot's values by ``spec`` in f32, divided by
    ``max(l, 1e-30)``, in ``dtype``, heads moved after the query axis."""
    mx = sharding.pmax([s.amax(dim=-1) for s in scores], home)
    pexp = [torch.exp(s - mx.to(s.device)[..., None]) for s in scores]
    l = sharding.psum([pe.sum(dim=-1) for pe in pexp], home)
    pv = sharding.psum([torch.einsum(spec, pe.to(dtype), v).float()
                        for pe, v in zip(pexp, values)], home)
    return (pv / torch.clamp(l[..., None], min=1e-30)).to(dtype).transpose(1, 2)


def _flash_decode(q, ck, cv, k_new, v_new, pos, *, mode: str, window: int, n_rep: int,
                  policy: ShardingPolicy, masks: dict | None = None):
    """Flash decoding over a cache sharded along its length, once a slot.

    The reference's ``shard_map`` body: model slot ``m`` owns the cache's
    slots ``[m·L_loc, (m+1)·L_loc)`` as a view ``ck[:, m·L_loc:(m+1)·L_loc]``
    (data slot ``d`` its block of the batch, where the data axes divide it);
    the slot whose window holds the step's slot writes the step's key and
    value there in place (every other slot writes back what it holds), then
    each computes its partial: f32 scores at ``1/sqrt(hd)``, ``-1e30`` where
    invalid; :func:`_flash_merge` merges them.  q: (B, 1, H, hd); ck/cv: (B,
    L, KVH, hd); k_new/v_new: (B, 1, KVH, hd).  Returns the output (B, 1, H,
    hd); the cache is written in place.
    """
    grid = sharding.slot_grid(policy)
    msize = grid.shape[1]
    L = ck.shape[1]
    L_loc = L // msize
    ring = mode == "sliding" and L == window
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid, slots = _shard_slots(masks, L, pos, ring, msize)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    outs = []
    for d, (b0, b1) in enumerate(_data_blocks(q.shape[0], grid.shape[0])):
        home = grid[d, 0]
        scores, values = [], []
        for m, (idx, in_range) in enumerate(slots):
            dev = _slot_device(grid, d, m, ck)
            a, b = m * L_loc, (m + 1) * L_loc
            wk, wv = ck[b0:b1, a:b], cv[b0:b1, a:b]
            _write_window(wk, idx.to(dev), in_range.to(dev), k_new[b0:b1].to(dev))
            _write_window(wv, idx.to(dev), in_range.to(dev), v_new[b0:b1].to(dev))
            kk = _repeat_kv(wk.to(q.dtype), n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", q[b0:b1].to(dev).float(), kk.float()) * scale
            scores.append(torch.where(valid[a:b].to(dev), s, neg.to(dev)))
            values.append(_repeat_kv(wv.to(q.dtype), n_rep))
        outs.append(_flash_merge(scores, values, "bhqk,bkhd->bhqd", q.dtype, home))
    return sharding.all_gather(outs, 0, grid[0, 0])


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                    mode: str, policy: ShardingPolicy | None = None,
                    kv_cache: dict | None = None,
                    decode_pos: torch.Tensor | None = None, decode_masks: dict | None = None,
                    x_cross: torch.Tensor | None = None) -> tuple[torch.Tensor, dict | None]:
    """Self-attention, or cross-attention from ``x`` to ``x_cross`` (whisper's
    encoder memory: no RoPE, the caller passes ``mode="full"``; query and key
    lengths differ).  ``mode`` is ``"causal"``, ``"sliding"`` or ``"full"``.

    Without a cache, attention over the whole sequence (train and prefill).
    With ``kv_cache`` ``{"k", "v"}`` of ``(B, L, KVH, hd)``, one decode step
    at the 0-d position ``decode_pos``: this step's key and value go to slot
    ``pos`` (``pos % L`` in a sliding layer's ring, ``L == sliding_window``),
    in place, and the query attends to the cache's valid slots (the mask
    from the step's ``decode_masks`` where given).  Cross-
    attention with a cache attends to the memory as without one and leaves
    the cache as it is.  Returns ``(y, kv_cache)``: the cache, updated in
    place, or ``None`` without one.

    Under an active ``policy`` that does not shard the KV heads, a decode
    step over a cache whose length the model axis divides takes
    :func:`_flash_decode`, as the reference routes it.
    """
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    n_rep = H // KVH
    B = x.shape[0]

    q, k, v = _project_qkv(p, x, x if x_cross is None else x_cross, cfg)
    if cfg.pos_embedding == "rope" and x_cross is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if (kv_cache is not None and x_cross is None and _seq_sharded(policy, kv_cache["k"].shape[1])
            and not policy.shard_kv_heads):
        pos = torch.as_tensor(decode_pos, device=x.device)
        out = _flash_decode(q, kv_cache["k"], kv_cache["v"], k, v, pos, mode=mode,
                            window=cfg.sliding_window, n_rep=n_rep, policy=policy,
                            masks=decode_masks)
    elif kv_cache is not None and x_cross is None:
        pos = torch.as_tensor(decode_pos, device=x.device)
        ck, cv = kv_cache["k"], kv_cache["v"]
        L = ck.shape[1]
        ring = mode == "sliding" and L == cfg.sliding_window
        slot = _slot(torch.remainder(pos, L) if ring else pos)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        out = _sdpa_naive(q, _repeat_kv(ck.to(x.dtype), n_rep), _repeat_kv(cv.to(x.dtype), n_rep),
                          _step_mask(decode_masks, L, pos, ring), scale=1.0 / math.sqrt(hd))
    else:
        out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), cfg, mode=mode,
                    window=cfg.sliding_window, policy=policy)
    out = out.reshape(B, -1, H * hd)
    return out @ p["wo"].to(out.dtype), kv_cache


# ---------------------------------------------------------------------------
# MLA (deepseek multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Low-rank q (``wq_a``, ``q_norm``, ``wq_b``) and the shared kv latent
    with its rope key (``wkv_a``, ``kv_norm``), its per-head expansions
    (``wk_b``, ``wv_b``) and ``wo``."""
    D, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": _dense_init(generator, (D, rq), cfg.param_dtype),
        "q_norm": torch.ones((rq,), dtype=cfg.param_dtype),
        "wq_b": _dense_init(generator, (rq, H * (dn + dr)), cfg.param_dtype),
        "wkv_a": _dense_init(generator, (D, rkv + dr), cfg.param_dtype),
        "kv_norm": torch.ones((rkv,), dtype=cfg.param_dtype),
        "wk_b": _dense_init(generator, (rkv, H * dn), cfg.param_dtype),
        "wv_b": _dense_init(generator, (rkv, H * dv), cfg.param_dtype),
        "wo": _dense_init(generator, (H * dv, D), cfg.param_dtype),
    }


def _mla_q(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = _rms_head_norm(p["q_norm"], x @ p["wq_a"].to(x.dtype))
    q = (cq @ p["wq_b"].to(x.dtype)).reshape(*x.shape[:-1], H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_latent(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The normed latent ``(B, S, rkv)`` and the rotated shared key ``(B, S, dr)``."""
    rkv = cfg.kv_lora_rank
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = _rms_head_norm(p["kv_norm"], kv[..., :rkv])
    k_pe = apply_rope(kv[..., None, rkv:], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_pe


def _mla_sharded_decode(q_lat, q_rope, ckv, kpe, c_new, kpe_new, pos, *, scale: float,
                        policy: ShardingPolicy, masks: dict | None = None) -> torch.Tensor:
    """MLA's absorbed decode over a latent cache sharded along its length,
    once a slot (the reference's ``shard_map`` body): model slot ``m`` owns
    ``ckv[:, m·L_loc:(m+1)·L_loc]`` and ``kpe``'s same window, the slot
    holding ``pos`` writes the step's latent and rope key in place, each
    computes f32 scores ``q_lat·ckv + q_rope·kpe`` at ``scale`` (``-1e30``
    past ``pos``); :func:`_flash_merge` merges them with the latent read-out
    ``exp·ckv``.  Returns the latent read-out (B, 1, H, rkv)."""
    grid = sharding.slot_grid(policy)
    msize = grid.shape[1]
    L = ckv.shape[1]
    L_loc = L // msize
    valid, slots = _shard_slots(masks, L, pos, False, msize)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q_lat.device)
    outs = []
    for d, (b0, b1) in enumerate(_data_blocks(q_lat.shape[0], grid.shape[0])):
        home = grid[d, 0]
        scores, lats = [], []
        for m, (idx, in_range) in enumerate(slots):
            dev = _slot_device(grid, d, m, ckv)
            a, b = m * L_loc, (m + 1) * L_loc
            wc, wp = ckv[b0:b1, a:b], kpe[b0:b1, a:b]
            _write_window(wc, idx.to(dev), in_range.to(dev), c_new[b0:b1].to(dev))
            _write_window(wp, idx.to(dev), in_range.to(dev), kpe_new[b0:b1].to(dev))
            wc_c = wc.to(q_lat.dtype)
            s = (torch.einsum("bqhr,bkr->bhqk", q_lat[b0:b1].to(dev).float(), wc_c.float())
                 + torch.einsum("bqhd,bkd->bhqk", q_rope[b0:b1].to(dev).float(),
                                wp.to(q_lat.dtype).float())) * scale
            scores.append(torch.where(valid[a:b].to(dev), s, neg.to(dev)))
            lats.append(wc_c)
        outs.append(_flash_merge(scores, lats, "bhqk,bkr->bhqr", q_lat.dtype, home))
    return sharding.all_gather(outs, 0, grid[0, 0])


def apply_mla(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
              mode: str, policy: ShardingPolicy | None = None, kv_cache: dict | None = None,
              decode_pos: torch.Tensor | None = None,
              decode_masks: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention.  ``mode`` is accepted as the reference
    accepts it; MLA is always causal.

    Train/prefill: the latent expanded to per-head keys and values, the
    shared rope key concatenated onto every head's nope key, attention at
    scale ``1/sqrt(nope + rope)`` with value heads of ``v_head_dim``.

    Decode, with ``kv_cache`` ``{"ckv": (B, L, rkv), "kpe": (B, L, dr)}``: the
    *absorbed* form.  The step's latent and rope key go to slot ``pos`` in
    place; the scores are ``(q_nope W_UK)·ckv + q_rope·kpe`` straight from the
    latent, the read-out ``probs·ckv`` stays in latent space and ``W_UV``
    expands it.  It rounds differently from the expanded prefill.  Under an
    active ``policy`` whose model axis divides the cache's length, the
    absorbed decode runs once a slot (:func:`_mla_sharded_decode`), as the
    reference routes it.  Returns ``(y, kv_cache)``.
    """
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_pe = _mla_kv_latent(p, x, cfg, positions)
    if kv_cache is None:
        k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(B, S, H, dn)
        v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(B, S, H, dv)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        out = _sdpa(q_eff, k_eff, v, cfg, mode="causal", policy=policy)
    elif _seq_sharded(policy, kv_cache["ckv"].shape[1]):
        pos = torch.as_tensor(decode_pos, device=x.device)
        wk_b = p["wk_b"].to(x.dtype).reshape(rkv, H, dn)
        wv_b = p["wv_b"].to(x.dtype).reshape(rkv, H, dv)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wk_b)
        o_lat = _mla_sharded_decode(q_lat, q_rope, kv_cache["ckv"], kv_cache["kpe"], c_kv, k_pe,
                                    pos, scale=1.0 / math.sqrt(dn + dr), policy=policy,
                                    masks=decode_masks)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b)
    else:
        pos = torch.as_tensor(decode_pos, device=x.device)
        ckv, kpe = kv_cache["ckv"], kv_cache["kpe"]
        ckv.index_copy_(1, _slot(pos), c_kv.to(ckv.dtype))
        kpe.index_copy_(1, _slot(pos), k_pe.to(kpe.dtype))
        wk_b = p["wk_b"].to(x.dtype).reshape(rkv, H, dn)
        wv_b = p["wv_b"].to(x.dtype).reshape(rkv, H, dv)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wk_b)
        ckv_c = ckv.to(x.dtype)
        scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckv_c.float())
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kpe.to(x.dtype).float()))
        scores = (scores * (1.0 / math.sqrt(dn + dr))
                  + _step_mask(decode_masks, ckv.shape[1], pos, False))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv_c)  # the latent read-out
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b)
    out = out.reshape(B, S, H * dv)
    return out @ p["wo"].to(out.dtype), kv_cache


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


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: ShardingPolicy | None = None) -> torch.Tensor:
    """``w_down(silu(x w_gate) * x w_up)``, or ``w_down(gelu_tanh(x w_up + b))``."""
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype), approximate="tanh")
    y = h @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        y = y + p["b_down"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MoE: shared experts + routed top-k, every expert on every token
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``router`` (σ = 0.02), the stacked experts ``we_gate``/``we_up``
    ``(E, D, F)`` and ``we_down`` ``(E, F, D)`` over the padded expert count,
    and a dense ``shared`` MLP when the config has shared experts."""
    D, E, Fd = cfg.d_model, cfg.padded_n_experts, cfg.moe_d_ff
    p = {
        "router": _dense_init(generator, (D, E), cfg.param_dtype, scale=0.02),
        "we_gate": _dense_init(generator, (E, D, Fd), cfg.param_dtype),
        "we_up": _dense_init(generator, (E, D, Fd), cfg.param_dtype),
        "we_down": _dense_init(generator, (E, Fd, D), cfg.param_dtype),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = init_mlp(generator, cfg,
                               d_ff=cfg.shared_d_ff or cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def _router_probs(p: dict, x_flat: torch.Tensor, cfg: ModelConfig):
    """``(probs, gates, idx)``: f32 softmax over the experts (padded ones at
    ``-1e30``), the top ``cfg.top_k`` by a stable descending sort (ties to
    the lower index, as ``lax.top_k``), gates renormalized by
    ``clip(sum, 1e-9)``.

    The router is rounded to ``x``'s dtype, then multiplied in f32: the
    reference's ``preferred_element_type=f32`` (a bf16 matmul would round
    its output).
    """
    E, E_real = cfg.padded_n_experts, cfg.n_experts
    logits = x_flat.float() @ p["router"].to(x_flat.dtype).float()
    if E != E_real:
        pad = torch.arange(E, device=logits.device) >= E_real
        logits = torch.where(pad, torch.full((), _NEG, device=logits.device), logits)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :cfg.top_k], order[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def moe_aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load balance, ``E · Σ_e f_e · P_e``: ``f`` the routed
    share of each expert (counts, not differentiated), ``P`` its mean
    probability (the gradient's only path)."""
    E = cfg.padded_n_experts
    T = probs.shape[0]
    flat = expert_idx.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32, device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=probs.device))
    f = counts / (T * cfg.top_k)
    return E * (f * probs.mean(dim=0)).sum()


def apply_moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The reference's MoE: **every expert on every token** (``(T, E, F)``
    through ``einsum``), combined with the top-k gates through a one-hot, so
    an unchosen expert's NaN reaches the output as ``NaN · 0`` there too.
    Plus the shared experts' dense MLP.  Returns ``(y, aux)``."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    probs, gates, idx = _router_probs(p, xf, cfg)
    h = torch.einsum("td,edf->tef", xf, p["we_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xf, p["we_up"].to(x.dtype))
    eo = torch.einsum("tef,efd->ted", F.silu(h) * u, p["we_down"].to(x.dtype))
    onehot = F.one_hot(idx, cfg.padded_n_experts).to(x.dtype)  # (T, k, E)
    comb = torch.einsum("tk,tke->te", gates.to(x.dtype), onehot)
    y = torch.einsum("te,ted->td", comb, eo).reshape(B, S, D)
    aux = moe_aux_loss(probs, idx, cfg)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def _ep_capacity(cfg: ModelConfig, T: int, dsize: int) -> int:
    """The reference's static capacity per expert and data block:
    ``max(ceil(T_loc · top_k / E · capacity_factor), top_k)``, ``T_loc =
    max(T // dsize, 1)``."""
    T_loc = max(T // dsize, 1)
    return max(int(math.ceil(T_loc * cfg.top_k / cfg.padded_n_experts * cfg.capacity_factor)),
               cfg.top_k)


def _ep_routes(idx: torch.Tensor, m: int, E_loc: int, C: int):
    """Model slot ``m``'s dispatch of one data block's routes ``idx`` (t_loc,
    top_k), as the reference ranks them: the assignments ``t·top_k + j`` to
    ``m``'s experts ``[m·E_loc, (m+1)·E_loc)``, stably sorted by local expert
    (the others last); an assignment's rank is its place among its expert's;
    one ranked below ``C`` is kept, at slot ``local_e·C + rank``, and every
    other goes to the overflow slot ``E_loc·C``.  Returns ``(flat_t, keep,
    slot)`` over the ``t_loc·top_k`` assignments."""
    t_loc, top_k = idx.shape
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t_loc, device=idx.device).repeat_interleave(top_k)
    local_e = flat_e - m * E_loc
    is_local = (local_e >= 0) & (local_e < E_loc)
    sort_key = torch.where(is_local, local_e, torch.full_like(local_e, E_loc))
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    counts = torch.zeros((E_loc + 1,), dtype=torch.int64, device=idx.device).index_add(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=0) - counts
    ranks_sorted = torch.arange(sorted_e.shape[0], device=idx.device) - starts[sorted_e]
    ranks = torch.empty_like(ranks_sorted).scatter(0, order, ranks_sorted)
    keep = is_local & (ranks < C)
    slot = torch.where(keep, local_e * C + ranks, torch.full_like(ranks, E_loc * C))
    return flat_t, keep, slot


def _ep_decode_layout(x: torch.Tensor, cfg: ModelConfig, policy: ShardingPolicy, grid) -> bool:
    """The reference's choice of the weights-stationary 2-D decode body: one
    token a sequence, a serving FSDP policy, and the experts and the batch
    dividing over the slots."""
    dsize, msize = grid.shape
    B, S, _ = x.shape
    E = cfg.padded_n_experts
    return (S == 1 and policy.serving and policy.fsdp_params
            and E % (msize * dsize) == 0 and B % dsize == 0)


def _moe_ep_dispatch(p: dict, x: torch.Tensor, cfg: ModelConfig, grid, E_loc: int, C: int):
    """The dispatch body, once a slot: data slot ``d`` routes its block of
    the batch (the router, the aux loss); model slot ``m`` gathers its kept
    assignments' tokens into an ``(E_loc, C, D)`` buffer in slot space, runs
    its experts' batched products, and scatter-adds the gated outputs back to
    the tokens; the partials are summed over model slots in ``x``'s dtype.
    FSDP's all-gather of the expert weights over the data axes is the whole
    tensor here (weights are not placed per slot), of which ``m`` reads its
    block.  Out-of-place ``scatter``/``index_add``, so gradients pass.

    The aux loss: the reference's ``out_specs=P()`` over a value that varies
    across data slots returns data slot 0's, and its gradient is that of the
    mean over the data slots; the port returns slot 0's value with the mean's
    gradient."""
    dsize, msize = grid.shape
    B, S, D = x.shape
    if B % dsize:
        raise ValueError(f"a batch of {B} does not divide over {dsize} data slots")
    B_loc = B // dsize
    n_slots = E_loc * C
    ys, auxes = [], []
    for d in range(dsize):
        home = grid[d, 0]
        xb = x[d * B_loc:(d + 1) * B_loc].to(home)
        xf = xb.reshape(-1, D)
        t_loc = xf.shape[0]
        # the router's result is the same on every model slot of the block
        probs, gates, idx = _router_probs({"router": p["router"].to(home)}, xf, cfg)
        auxes.append(moe_aux_loss(probs, idx, cfg))
        flat_g = gates.reshape(-1)
        parts = []
        for m in range(msize):
            dev = grid[d, m]
            flat_t, keep, slot = _ep_routes(idx.to(dev), m, E_loc, C)
            g = torch.where(keep, flat_g.to(dev), torch.zeros((), device=dev))
            tok = torch.full((n_slots + 1,), t_loc, dtype=torch.int64, device=dev).scatter(
                0, slot, flat_t)[:n_slots]
            gate = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev).scatter(
                0, slot, g)[:n_slots]
            valid = torch.zeros((n_slots + 1,), dtype=torch.bool, device=dev).scatter(
                0, slot, keep)[:n_slots]
            xs = xf.to(dev)
            xf_pad = torch.cat([xs, xs.new_zeros((1, D))], dim=0)
            buf = (xf_pad[tok] * valid[:, None].to(xs.dtype)).reshape(E_loc, C, D)
            e0, e1 = m * E_loc, (m + 1) * E_loc
            h = torch.einsum("ecd,edf->ecf", buf, p["we_gate"][e0:e1].to(dev).to(xs.dtype))
            u = torch.einsum("ecd,edf->ecf", buf, p["we_up"][e0:e1].to(dev).to(xs.dtype))
            eo = torch.einsum("ecf,efd->ecd", F.silu(h) * u,
                              p["we_down"][e0:e1].to(dev).to(xs.dtype))
            contrib = eo.reshape(n_slots, D) * gate[:, None].to(eo.dtype)
            parts.append(torch.zeros((t_loc + 1, D), dtype=xs.dtype, device=dev).index_add(
                0, tok, contrib)[:t_loc])
        ys.append(sharding.psum(parts, home).reshape(xb.shape))
    y = sharding.all_gather(ys, 0, grid[0, 0])
    if dsize == 1:
        return y, auxes[0]
    mean = sharding.pmean(auxes, grid[0, 0])
    return y, auxes[0].detach() + (mean - mean.detach())


def _moe_ep_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, grid):
    """The weights-stationary 2-D decode body, once a slot: every slot
    gathers the whole batch's tokens (the data blocks in slot order) and
    routes them; slot ``(m, d)`` owns the experts ``[e0, e0 + E_loc2)``,
    ``e0 = (m·dsize + d)·E_loc2``, ``E_loc2 = E / (msize·dsize)``, and adds
    each token's gated outputs of those it routes to; the partials are summed
    over every slot, model-major, in ``x``'s dtype.  The aux loss is the
    whole batch's."""
    dsize, msize = grid.shape
    B, S, D = x.shape
    E_loc2 = cfg.padded_n_experts // (msize * dsize)
    home = grid[0, 0]
    xf = x.to(home).reshape(-1, D)
    probs, gates, idx = _router_probs({"router": p["router"].to(home)}, xf, cfg)
    aux = moe_aux_loss(probs, idx, cfg)
    parts = []
    for m in range(msize):
        for d in range(dsize):
            dev = grid[d, m]
            e0 = (m * dsize + d) * E_loc2
            ids = torch.arange(e0, e0 + E_loc2, device=dev)
            sel = idx.to(dev)[:, :, None] == ids[None, None, :]
            gate_e = torch.where(sel, gates.to(dev)[:, :, None], 0.0).sum(dim=1)
            xs = xf.to(dev)
            wg, wu, wd = (p[k][e0:e0 + E_loc2].to(dev).to(xs.dtype)
                          for k in ("we_gate", "we_up", "we_down"))
            h = torch.einsum("td,edf->tef", xs, wg)
            u = torch.einsum("td,edf->tef", xs, wu)
            parts.append(torch.einsum("tef,efd->td",
                                      F.silu(h) * u * gate_e.to(h.dtype)[:, :, None], wd))
    return sharding.psum(parts, home).reshape(B, S, D), aux


def apply_moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, policy: ShardingPolicy):
    """Expert-parallel MoE over the policy's slots (the reference's
    ``shard_map`` over the model axis), plus the shared experts' MLP.

    One token a sequence under a serving FSDP policy whose slots divide the
    experts and the batch: the weights-stationary 2-D decode body
    (:func:`_moe_ep_decode`, no capacity).  Otherwise the dispatch body
    (:func:`_moe_ep_dispatch`): each model slot owns ``E / model_size``
    experts, each data slot's block of the batch is ranked on its own, and
    an expert takes at most ``C`` (:func:`_ep_capacity`) of a block's
    assignments; the rest are dropped.  Returns ``(y, aux)``."""
    grid = sharding.slot_grid(policy)
    dsize, msize = grid.shape
    E = cfg.padded_n_experts
    if E % msize:
        raise ValueError(f"{E} experts do not divide over {msize} model slots")
    B, S, _ = x.shape
    if _ep_decode_layout(x, cfg, policy, grid):
        y, aux = _moe_ep_decode(p, x, cfg, grid)
    else:
        y, aux = _moe_ep_dispatch(p, x, cfg, grid, E // msize, _ep_capacity(cfg, B * S, dsize))
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg, policy)
    return y, aux


def moe_ep_kept(p: dict, x: torch.Tensor, cfg: ModelConfig,
                policy: ShardingPolicy) -> torch.Tensor:
    """Which of the ``(B·S, top_k)`` routes :func:`apply_moe_ep` keeps: under
    the dispatch body those ranked within capacity on their expert's model
    slot and data block, under the 2-D decode body every one."""
    grid = sharding.slot_grid(policy)
    dsize, msize = grid.shape
    B, S, D = x.shape
    if _ep_decode_layout(x, cfg, policy, grid):
        return torch.ones((B * S, cfg.top_k), dtype=torch.bool, device=x.device)
    E_loc = cfg.padded_n_experts // msize
    C = _ep_capacity(cfg, B * S, dsize)
    kept = []
    with torch.no_grad():
        for xb in x.reshape(dsize, -1, D):
            _, _, idx = _router_probs({"router": p["router"]}, xb, cfg)
            keep = torch.zeros(idx.numel(), dtype=torch.bool, device=x.device)
            for m in range(msize):
                keep = keep | _ep_routes(idx, m, E_loc, C)[1]
            kept.append(keep.reshape(idx.shape))
    return torch.cat(kept, dim=0)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: ShardingPolicy | None = None):
    """The expert-parallel MoE under an active policy (:func:`apply_moe_ep`),
    the dense MoE otherwise, as the reference routes it."""
    if policy is not None and policy.active:
        return apply_moe_ep(p, x, cfg, policy)
    return apply_moe_dense(p, x, cfg)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, state space duality)
# ---------------------------------------------------------------------------


def init_mamba(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``in_proj`` (z, x, B, C, dt), the depthwise ``conv_w``/``conv_b``,
    ``A_log = log(linspace(1, 16, H))``, ``D_skip`` 1, ``dt_bias`` at
    softplus⁻¹(0.01), the gated norm's ``norm`` and ``out_proj``."""
    D = cfg.d_model
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pd = cfg.param_dtype
    return {
        "in_proj": _dense_init(generator, (D, 2 * di + 2 * N + H), pd),
        "conv_w": _dense_init(generator, (cfg.conv_width, di + 2 * N), pd, scale=0.2),
        "conv_b": torch.zeros((di + 2 * N,), dtype=pd),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(pd),
        "D_skip": torch.ones((H,), dtype=pd),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01))).to(pd),
        "norm": torch.ones((di,), dtype=pd),
        "out_proj": _dense_init(generator, (di, D), pd),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, in f32, then SiLU.  xBC: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(W):
        out = out + pad[:, i:i + S, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan, in f32.

    xh: (B, S, H, P); dt: (B, S, H), positive; A: (H,), negative; Bm, Cm:
    (B, S, N), one group.  Returns y: (B, S, H, P).  The tail is padded with
    ``dt = 0`` (unit decay, no state writes); the reference's inter-chunk
    ``lax.scan`` is a loop over chunks.  The intra-chunk decay keeps the
    reference's ``where(tri, exp(rel), 0)``: ``exp`` of the positive ``rel``
    above the diagonal is computed and discarded, as there.
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // Q
    xc = xh.reshape(Bsz, nc, Q, H, Pd).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    cum_a = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, H) inclusive log-decay

    # intra-chunk: L[t, s] = exp(cum_a[t] - cum_a[s]) for t >= s
    rel = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    Lmat = torch.where(tri[None, None, :, :, None], torch.exp(rel),
                       torch.zeros((), device=xh.device))
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bctsh,bcshp->bcthp", scores[..., None] * Lmat, xdt)

    # each chunk's own state: Σ_s exp(cum_a[Q-1] - cum_a[s]) dt_s B_s ⊗ x_s
    decay_to_end = torch.exp(cum_a[:, :, -1:, :] - cum_a)
    st = torch.einsum("bcsh,bcsn,bcshp->bchpn", decay_to_end * dtc, Bc, xc)

    # the state entering each chunk, chunk by chunk
    chunk_decay = torch.exp(cum_a[:, :, -1, :])  # (B, nc, H)
    carry = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + st[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    y_off = torch.einsum("bctn,bcth,bchpn->bcthp", Cc, torch.exp(cum_a), prev_states)
    return (y_diag + y_off).reshape(Bsz, nc * Q, H, Pd)[:, :S]


def apply_mamba(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                policy: ShardingPolicy | None = None,
                cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """Mamba2 mixer: in-projection, causal conv, the SSM plus the ``D`` skip,
    the gated RMS norm ``norm(y · silu(z))`` in f32, out-projection.

    Train/prefill: the causal conv over the sequence and the chunked SSD.
    Decode, with ``cache`` ``{"conv": (B, W-1, di+2N), "ssm": (B, H, P, N)}``:
    the conv over the cached ``W-1`` inputs and this one (accumulated in f32,
    then SiLU), then one step of the recurrence ``st = st·exp(dt·A) +
    dt·B⊗x``, ``y = st·C``; the shifted window and the new state are written
    back in place in the cache's dtypes.  Returns ``(y, cache)``.
    """
    B, S, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = x @ p["in_proj"].to(x.dtype)
    z, xi, Bm, Cm, dt_raw = torch.split(proj, [di, di, N, N, H], dim=-1)
    xBC = torch.cat([xi, Bm, Cm], dim=-1)
    if cache is None:
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    else:
        # the causal conv's last output over the cached inputs and this one
        window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)  # (B, W, ch)
        xBC = _causal_conv(window, p["conv_w"], p["conv_b"])[:, -1:]
        cache["conv"].copy_(window[:, 1:, :])
    xi, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xh = xi.reshape(B, S, H, cfg.ssm_head_dim)
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if cache is None:
        y = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    else:
        st = cache["ssm"].float() * torch.exp(dt[:, 0, :] * A)[:, :, None, None]
        st = st + torch.einsum("bh,bn,bhp->bhpn", dt[:, 0, :], Bm[:, 0, :].float(),
                               xh[:, 0].float())
        y = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0, :].float())[:, None]
        cache["ssm"].copy_(st)
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di) * F.silu(z.float())
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-6) * p["norm"].float()
    return y.to(x.dtype) @ p["out_proj"].to(x.dtype), cache
