"""Parallelized model aggregation — the paper's core contribution, on the card.

The port of the f32 and int8 single-device rules of
``repro/core/aggregation.py``.
The model is packed into one flat buffer per learner (``core/packing.py``),
so FedAvg over an arbitrarily deep model is one weighted reduction over an
``(N, P)`` stack — elementwise over ``P``, a short loop over ``N``.

Every reduction dispatches through ``kernels/ops``: on a CUDA tensor it
launches the hand-written Hopper kernel (``kernels/csrc/fedavg.cu``), on a
CPU tensor it runs the plain torch einsum.  ``masked_staleness_average``
computes its staleness-damped weights in torch and reduces through the same
masked kernel, so no einsum stays on a CUDA path.

The int8 arena's rules (:func:`masked_fedavg_q8`,
:func:`masked_staleness_q8`) reduce through ``ops.masked_fedavg_q8``: the
fused dequant-into-aggregate kernel on the card (``kernels/csrc/fused_agg.cu``),
the plain dequantize-``where``-einsum on the host.

Robust rules (median, trimmed mean), the top-k forms and the sharded
variants belong to later slices of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fedavg import masked_normalize
from repro_torch.kernels.fedavg import normalize as _normalize

__all__ = [
    "fedavg",
    "weighted_average",
    "masked_normalize",
    "masked_weighted_average",
    "masked_fedavg",
    "masked_staleness_average",
    "masked_fedavg_q8",
    "masked_staleness_q8",
    "staleness_weights",
]


def weighted_average(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(N, P) × (N,) -> (P,)`` normalized weighted mean (uniform if Σw = 0)."""
    return ops.fedavg(stack, weights)


# FedAvg is a weighted average with example counts as weights.
fedavg = weighted_average


def masked_weighted_average(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """``(N, P) × (N,) × (N,) -> (P,)`` weighted mean over valid rows only.

    ``arena`` is the persistent device-resident buffer
    (``core/store.ArenaStore``); ``mask`` (1.0 valid / 0.0 invalid) folds row
    selection into the weights, so the reduction stays one pass — no gather,
    no re-stack.  Invalid rows are excluded before the multiply, so garbage
    (e.g. NaN) in a dead row cannot poison the aggregate.
    """
    return ops.masked_fedavg(arena, weights, mask)


# Masked FedAvg is a masked weighted average with example counts as weights.
masked_fedavg = masked_weighted_average


def staleness_weights(
    num_examples: torch.Tensor, staleness: torch.Tensor, alpha: float = 0.5
) -> torch.Tensor:
    """Asynchronous-protocol weights ``w_i ∝ n_i · (1 + s_i)^(-alpha)``."""
    n = torch.as_tensor(num_examples).to(torch.float32)
    s = torch.as_tensor(staleness).to(torch.float32)
    return n * (1.0 + s) ** (-alpha)


def masked_staleness_average(
    arena: torch.Tensor,
    num_examples: torch.Tensor,
    versions: torch.Tensor,
    current_version: float,
    mask: torch.Tensor,
    alpha: float = 0.5,
) -> torch.Tensor:
    """Staleness-damped masked mean straight off the arena.

    ``s_i = max(current_version - v_i, 0)`` from the per-row versions, damped
    by :func:`staleness_weights`, then reduced by the masked kernel.
    """
    stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
    return ops.masked_fedavg(arena, staleness_weights(num_examples, stal, alpha), mask)


def masked_fedavg_q8(
    q: torch.Tensor,
    scales: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    group: int = 256,
) -> torch.Tensor:
    """Masked FedAvg straight off a quantized arena, in one fused pass.

    ``(N, P)`` int8 × ``(N, P//group)`` f32 × ``(N,)`` × ``(N,)`` -> ``(P,)``:
    the int8-arena statement of :func:`masked_weighted_average`; the f32
    ``(N, P)`` stack is never built on the card.  The controller's dispatch
    for ``arena_dtype="int8"``.
    """
    return ops.masked_fedavg_q8(q, scales, weights, mask, group)


def masked_staleness_q8(
    q: torch.Tensor,
    scales: torch.Tensor,
    num_examples: torch.Tensor,
    versions: torch.Tensor,
    current_version: float,
    mask: torch.Tensor,
    alpha: float = 0.5,
    group: int = 256,
) -> torch.Tensor:
    """Staleness-damped masked mean straight off a quantized arena.

    The int8-arena statement of :func:`masked_staleness_average`: the
    staleness discount on the ``(N,)`` vectors, then the fused
    dequantize-mask-reduce over the int8 rows.
    """
    stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
    return ops.masked_fedavg_q8(q, scales, staleness_weights(num_examples, stal, alpha),
                                mask, group)
