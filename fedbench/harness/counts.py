"""The yardstick's arithmetic: useful FLOPs of the LM step, the bytes each
kernel must move, and the card's data-sheet peaks.

A frozen copy kept with the benchmark, so a change to the program cannot move
it.  The peaks are NVIDIA's H100 SXM data sheet (dense rates, 700 W), as
``repro_torch/launch/mesh.HARDWARE`` and ``chip_smoke.py`` state them.

FLOPs count matrix products only, two a multiply-add, as the shapes require
them: causal attention its needed half (a query at position ``t`` sees
``t + 1`` keys), a MoE its ``top_k`` routed experts and its shared experts
(not every expert, which the port's dense MoE runs today), the head over the
logical vocabulary.  A trained token costs three forward passes, an evaluated
one one.  Bytes count each input byte read once and each output byte written
once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s, one H100 SXM
HBM_BYTES_PER_S = 3.35e12  # HBM3, one H100 SXM
TRAIN_PASSES = 3  # forward + backward (two products of the forward's size)

QUANT_GROUP = 256  # the int8 codec's group: one f32 scale a group


def _attn_dims(cfg: dict) -> tuple[int, int, int, int]:
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
    return cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], hd


def layer_forward_flops(cfg: dict, seq_len: int, executed: bool = False) -> float:
    """One decoder layer's forward FLOPs per token.  ``executed`` counts what
    the port's eager path runs today instead: the full score square and every
    (padded) expert on every token."""
    D, H, KVH, hd = _attn_dims(cfg)
    flops = 2 * D * H * hd + 2 * 2 * D * KVH * hd + 2 * H * hd * D  # q, k, v, o
    keys = seq_len if executed else (seq_len + 1) / 2
    flops += 2 * 2 * H * hd * keys  # q k^T and p v
    if cfg["n_experts"]:
        E = cfg["n_experts"]
        if executed:
            m = cfg["expert_pad_to"]
            E = -(-E // m) * m
            flops += 2 * D * E + 3 * 2 * D * cfg["moe_d_ff"] * E + 2 * E * D
        else:
            flops += 2 * D * E + 3 * 2 * D * cfg["moe_d_ff"] * cfg["top_k"]
        if cfg["n_shared_experts"]:
            shared = cfg["shared_d_ff"] or cfg["moe_d_ff"] * cfg["n_shared_experts"]
            flops += 3 * 2 * D * shared
    else:
        flops += 3 * 2 * D * cfg["d_ff"]
    return float(flops)


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_to"]
    return -(-cfg["vocab_size"] // m) * m


def forward_flops_per_token(cfg: dict, seq_len: int, executed: bool = False) -> float:
    """The model's forward FLOPs per token at ``seq_len``: every layer and
    the head (over the padded vocabulary when ``executed``)."""
    vocab = padded_vocab(cfg) if executed else cfg["vocab_size"]
    return cfg["n_layers"] * layer_forward_flops(cfg, seq_len, executed) + 2 * cfg["d_model"] * vocab


def useful_flops(cfg: dict, seq_len: int, trained_tokens: float, evaluated_tokens: float) -> float:
    """Useful FLOPs of training ``trained_tokens`` and evaluating
    ``evaluated_tokens`` tokens of sequences of ``seq_len``."""
    per_token = forward_flops_per_token(cfg, seq_len)
    return per_token * (TRAIN_PASSES * trained_tokens + evaluated_tokens)


def fedavg_f32_bytes(rows: int, width: int) -> float:
    """Kernel 1: ``rows`` live f32 rows of ``width`` read, the f32 mean
    written, the weights and mask read."""
    return float(4 * rows * width + 4 * width + 2 * 4 * rows)


def fedavg_q8_bytes(rows: int, width: int) -> float:
    """Kernel 5: ``rows`` live int8 rows and their group scales read, the f32
    mean written, the weights and mask read."""
    return float(rows * width + 4 * rows * (width // QUANT_GROUP) + 4 * width + 2 * 4 * rows)


def quantize_bytes(n: int, n_padded: int) -> float:
    """Kernel 3: ``n`` f32 values read (the pad reads as zeros), ``n_padded``
    int8 values and their group scales written."""
    return float(4 * n + n_padded + 4 * (n_padded // QUANT_GROUP))


def quant_padded(n: int, adaptive: bool = True, group: int = QUANT_GROUP,
                 block_rows: int = 64) -> int:
    """The padded length an ``(n,)`` row is quantized to: whole tiles of
    ``group * rows`` values.  The uplink's codec (``adaptive``) takes for
    ``rows`` the tallest block up to ``block_rows`` whose row padding stays
    within a sixteenth of the rows needed; the downlink's leaf codec always
    ``block_rows``."""
    rows_needed = max(1, -(-n // group))
    if not adaptive:
        rows = block_rows
    elif rows_needed <= block_rows:
        rows = rows_needed
    else:
        budget = -(-rows_needed // 16)
        rows = next(r for r in range(block_rows, 0, -1) if (-rows_needed) % r <= budget)
    tile = group * rows
    return -(-n // tile) * tile


def bound_seconds(nbytes: float) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
