"""Model configuration covering all assigned architecture families.

A framework-free copy of ``repro/models/config.py`` with torch dtypes.  One
dataclass describes dense (GQA / MLA / sliding-window), MoE (shared + routed
top-k), SSM (Mamba2/SSD), hybrid (Mamba2 + shared attention),
encoder-decoder (Whisper), and stub-frontend (VLM/audio) architectures.
Every field of the reference is kept, and the port trains every family.

The layer stack is described by a *pattern* of layer kinds that is cycled
over ``n_layers`` and then compiled into homogeneous *segments*
(``plan_segments``): each segment's parameters carry a leading ``repeats``
axis, as the reference's stacked scan parameters do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["ModelConfig", "LayerSpec", "Segment", "plan_segments", "padded_vocab",
           "ATTN", "SWA", "MAMBA", "SHARED_ATTN", "XATTN"]

# layer kinds
ATTN = "attn"  # full (global) self-attention + MLP/MoE
SWA = "swa"  # sliding-window self-attention + MLP
MAMBA = "mamba"  # Mamba2 (SSD) mixer + (optional) MLP
SHARED_ATTN = "shared_attn"  # zamba2-style tied full-attention block
XATTN = "xattn"  # decoder layer with self-attn + cross-attn (whisper)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's kind, and whether its MLP is a routed-expert MoE."""

    kind: str
    moe: bool = False  # routed-expert MLP instead of dense MLP


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeats`` steps, each applying ``unit`` layer specs in order."""

    unit: tuple[LayerSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        """Layers in the segment."""
        return len(self.unit) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the reference's fields, torch dtypes).

    ``remat`` is kept for parity with the reference's configs; the port's
    forward does not act on it (it changes no number).
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int  # logical vocabulary
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    attn_impl: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 4096
    layer_pattern: tuple[str, ...] = (ATTN,)
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0  # routed experts (possibly padded, see expert_pad_to)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0  # 0 -> moe_d_ff * n_shared_experts
    first_k_dense: int = 0  # leading dense layers before MoE starts (deepseek)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    expert_pad_to: int = 1  # pad n_experts up to a multiple of this

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # modality frontend stub (vlm/audio): precomputed embeddings of dim
    # ``frontend_dim`` projected into d_model and prepended to the sequence.
    frontend: str | None = None  # "vision_stub" | "audio_stub"
    frontend_dim: int = 0
    num_prefix_tokens: int = 0

    # deepseek multi-token prediction: extra predict depth (0 = off)
    mtp_depth: int = 0

    # attention execution: chunked = online softmax over KV blocks, taken
    # from ``attn_chunk_min_len`` keys on; attn_naive=True forces the
    # full-score path.
    attn_naive: bool = False
    attn_k_chunk: int = 1024
    attn_chunk_min_len: int = 2048  # use naive below this KV length

    # block details
    mlp_gated: bool = True  # SiLU-gated (llama-style) vs plain GELU (whisper)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    pos_embedding: str = "rope"  # rope | sinusoidal (whisper)

    # numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    vocab_pad_to: int = 256
    remat: bool = True
    scan_layers: bool = True
    tie_embeddings: bool = False

    # citation of the source model card / paper for this config
    source: str = ""

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        """``head_dim``, or ``d_model // n_heads`` when it is 0."""
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab_size(self) -> int:
        """The vocabulary padded up to a multiple of ``vocab_pad_to``."""
        return padded_vocab(self.vocab_size, self.vocab_pad_to)

    @property
    def padded_n_experts(self) -> int:
        """Routed experts padded up to a multiple of ``expert_pad_to``."""
        if self.n_experts == 0:
            return 0
        m = self.expert_pad_to
        return ((self.n_experts + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba2 heads."""
        return self.d_inner // self.ssm_head_dim

    def layer_specs(self) -> list[LayerSpec]:
        """Expand the cycled pattern into one spec per layer."""
        specs = []
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            moe = (
                self.n_experts > 0
                and kind in (ATTN, SWA)
                and i >= self.first_k_dense
            )
            specs.append(LayerSpec(kind=kind, moe=moe))
        return specs

    def param_count_estimate(self) -> int:
        """Closed-form parameter estimate (the reference's formula)."""
        D, F, Vp = self.d_model, self.d_ff, self.padded_vocab_size
        hd = self.resolved_head_dim
        total = Vp * D  # embed
        if not self.tie_embeddings:
            total += D * Vp
        for spec in self.layer_specs():
            if spec.kind in (ATTN, SWA, SHARED_ATTN, XATTN):
                if self.attn_impl == "mla":
                    r_q = self.q_lora_rank or D
                    total += D * r_q + r_q * self.n_heads * (
                        self.qk_nope_head_dim + self.qk_rope_head_dim
                    )
                    total += D * (self.kv_lora_rank + self.qk_rope_head_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim
                    )
                    total += self.n_heads * self.v_head_dim * D
                else:
                    total += D * self.n_heads * hd  # wq
                    total += 2 * D * self.n_kv_heads * hd  # wk, wv
                    total += self.n_heads * hd * D  # wo
                if spec.kind == XATTN:  # cross-attention second block
                    total += 2 * (D * self.n_heads * hd) + 2 * (D * self.n_kv_heads * hd)
            if spec.kind == MAMBA:
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                total += D * (2 * di + 2 * N + H)  # in_proj(z,x,B,C,dt)
                total += di * D  # out_proj
                total += self.conv_width * (di + 2 * N)
            # mlp / moe
            if spec.kind in (ATTN, SWA, SHARED_ATTN, XATTN):
                if spec.moe:
                    E = self.padded_n_experts
                    total += E * 3 * D * self.moe_d_ff
                    total += D * E  # router
                    sf = self.shared_d_ff or self.moe_d_ff * max(self.n_shared_experts, 1)
                    if self.n_shared_experts:
                        total += 3 * D * sf
                else:
                    total += 3 * D * F  # gated mlp
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += 4 * D * self.n_heads * hd + 3 * D * F
        return int(total)


def padded_vocab(vocab: int, multiple: int) -> int:
    """``vocab`` rounded up to a multiple of ``multiple``."""
    return int(math.ceil(vocab / multiple) * multiple)


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    """Compile the per-layer spec list into maximal segments.

    Strategy: find the repeating unit (the full cycled pattern) and emit
    ``Segment(unit, repeats)`` for as many whole cycles as fit, then a
    remainder segment with ``repeats=1``.  Homogeneous patterns collapse to a
    single one-layer unit repeated ``n_layers`` times (minus any
    ``first_k_dense`` prefix, which becomes its own leading segment).
    """
    specs = cfg.layer_specs()
    segments: list[Segment] = []
    i = 0
    # leading dense prefix (deepseek first_k_dense): its own segment
    if cfg.first_k_dense > 0:
        segments.append(Segment(unit=tuple(specs[: cfg.first_k_dense]), repeats=1))
        i = cfg.first_k_dense
    rest = specs[i:]
    if not rest:
        return segments
    unit_len = len(cfg.layer_pattern)
    if all(s == rest[0] for s in rest):
        # fully homogeneous: one spec repeated len(rest) times
        segments.append(Segment(unit=(rest[0],), repeats=len(rest)))
        return segments
    repeats = len(rest) // unit_len
    if repeats > 0:
        segments.append(Segment(unit=tuple(rest[:unit_len]), repeats=repeats))
    rem = rest[repeats * unit_len :]
    if rem:
        segments.append(Segment(unit=tuple(rem), repeats=1))
    return segments
