"""Plain reference of the federated LM: the decoder's forward and loss.

A frozen copy of the model's equations, written in plain PyTorch in float32
(TF32 off), imported by nothing of the program and importing nothing of it.
It follows the port's layer equations (those of the JAX package): pre-norm
RMSNorm (eps 1e-6), rotary position embeddings (rotate-half over the two
halves of a head), grouped-query causal attention with an additive -1e30
mask, a SiLU-gated MLP, or for a MoE a softmax router over the padded
experts (pad experts at -1e30), the top ``top_k`` by a stable descending
sort with gates renormalized by their sum, one ungated shared SiLU MLP, and
the Switch load-balance term ``E * sum_e f_e P_e`` at ``router_aux_coef``;
the head is the tied embedding or ``lm_head``, the padded vocabulary masked
at -1e30, and the loss the mean next-token cross-entropy.

Departures from the port's executed arithmetic, none of which changes the
mathematics: everything is float32 (the port computes in bfloat16 with f32
attention scores and norm statistics); a MoE computes each expert only on the
tokens routed to it (the port runs every expert on every token and zeroes
the unchosen ones through a one-hot).

``precision="fp8"`` is the control: every matrix product rounds both of its
operands to float8 e4m3 with a per-tensor scale (amax / 448) first, the
precision below the bfloat16 the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30
FP8_MAX = 448.0


def _fq(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, gradient straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


class Ops:
    """The reference's matrix product at a precision: ``"f32"`` or ``"fp8"``."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fq(a), _fq(b)
        return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p: dict, x: torch.Tensor, cfg: dict, ops: Ops) -> torch.Tensor:
    B, S, D = x.shape
    H, KVH = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or D // H
    q, k, v = ops.mm(x, p["wq"]), ops.mm(x, p["wk"]), ops.mm(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope(q.reshape(B, S, H, hd), cfg["rope_theta"])
    k = _rope(k.reshape(B, S, KVH, hd), cfg["rope_theta"])
    v = v.reshape(B, S, KVH, hd)
    rep = H // KVH
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)  # (B, H, S, hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    mask = torch.full((S, S), NEG, device=x.device).triu_(1)
    probs = torch.softmax(ops.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + mask, dim=-1)
    out = ops.mm(probs, v).transpose(1, 2).reshape(B, S, H * hd)
    return ops.mm(out, p["wo"])


def _mlp(w_gate, w_up, w_down, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    return ops.mm(F.silu(ops.mm(x, w_gate)) * ops.mm(x, w_up), w_down)


def _moe(p: dict, x: torch.Tensor, cfg: dict, ops: Ops) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed and shared experts' output and the router's statistics
    ``(2, E)``: each expert's routed count and its summed probability (see
    :func:`aux_loss`)."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    E = p["router"].shape[-1]
    logits = ops.mm(xf, p["router"])
    pad = torch.arange(E, device=x.device) >= cfg["n_experts"]
    logits = torch.where(pad, torch.full_like(logits, NEG), logits)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :cfg["top_k"]], order[:, :cfg["top_k"]]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(xf)
    for e in range(cfg["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = _mlp(p["we_gate"][e], p["we_up"][e], p["we_down"][e], xf[tok], ops)
            y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    counts = torch.zeros(E, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    if "shared_w_gate" in p:
        y = y + _mlp(p["shared_w_gate"], p["shared_w_up"], p["shared_w_down"], xf, ops)
    return y.reshape(B, S, D), torch.stack([counts, probs.sum(0)])


def aux_loss(stats: torch.Tensor, tokens: int, top_k: int) -> torch.Tensor:
    """The Switch load-balance term ``E * sum_e f_e P_e`` of one layer from its
    router statistics over ``tokens`` tokens (``f`` routed shares, ``P`` mean
    probabilities); statistics of several blocks of rows add up."""
    counts, prob_sum = stats
    return stats.shape[-1] * (counts / (tokens * top_k) * prob_sum / tokens).sum()


_LAYER = "['segments'][0][0]"


def _layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves under short names (``wq``, ``router``, ``shared_w_up``...)."""
    out = {}
    for name, t in params.items():
        if name.startswith(_LAYER):
            keys = [k.strip("'") for k in name[len(_LAYER) + 1:-1].split("][")]
            short = keys[-1] if keys[0] != "moe" or keys[1] != "shared" else "shared_" + keys[-1]
            out[(keys[0] if keys[0].startswith("norm") else "") + short] = t[i]
    return out


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: dict,
                   ops: Ops) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The final normed hidden states ``(B, S, D)`` and each MoE layer's
    router statistics."""
    x = params["['embed']"][tokens]
    stats = []
    for i in range(cfg["n_layers"]):
        p = _layer_params(params, i)
        x = x + _attention(p, _rms(x, p["norm1scale"]), cfg, ops)
        h = _rms(x, p["norm2scale"])
        if cfg["n_experts"]:
            y, st = _moe(p, h, cfg, ops)
            x = x + y
            stats.append(st)
        else:
            x = x + _mlp(p["w_gate"], p["w_up"], p["w_down"], h, ops)
    return _rms(x, params["['final_norm']['scale']"]), stats


def token_losses(params: dict, batch: dict, cfg: dict,
                 ops: Ops) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Per-token cross-entropy ``(B, S)`` and each MoE layer's router statistics."""
    h, stats = forward_hidden(params, batch["tokens"], cfg, ops)
    head = params["['lm_head']"] if "['lm_head']" in params else params["['embed']"].T
    logits = ops.mm(h, head)
    V = cfg["vocab_size"]
    if logits.shape[-1] != V:
        logits = torch.cat([logits[..., :V], torch.full_like(logits[..., V:], NEG)], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, batch["labels"][..., None], dim=-1)[..., 0], stats


def objective(nll_mean: torch.Tensor, stats: list[torch.Tensor], tokens: int,
              cfg: dict) -> torch.Tensor:
    """Mean cross-entropy plus ``router_aux_coef`` times each MoE layer's aux."""
    for st in stats:
        nll_mean = nll_mean + cfg["router_aux_coef"] * aux_loss(st, tokens, cfg["top_k"])
    return nll_mean


def lm_loss(params: dict, batch: dict, cfg: dict, ops: Ops) -> torch.Tensor:
    """The training objective of one batch."""
    nll, stats = token_losses(params, batch, cfg, ops)
    return objective(nll.mean(), stats, nll.numel(), cfg)
