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

The robust rules are order statistics, weight-blind by design.
:func:`masked_trimmed_mean` reduces through ``ops.masked_trimmed_mean``: the
hand-written sorting-network kernel on the card (``kernels/csrc/robust.cu``), the
plain sort-then-trim on the host.  The median rules and the stack store's
:func:`trimmed_mean` are ``jnp.sort``/``jnp.median`` in the reference, outside
any Pallas kernel, so they stay ``torch.sort`` here (never ``torch.median``,
which returns the lower middle value where ``jnp.median`` averages the two).
Each of those sorts first makes every NaN positive
(``kernels/robust.positive_nan``): ``torch.sort`` on the card puts a negative
NaN first, where the host and ``jnp.sort`` put every NaN last.

The top-k forms and the sharded variants belong to later slices of the port
(``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fedavg import masked_normalize
from repro_torch.kernels.robust import positive_nan

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
    "coordinate_median",
    "trimmed_mean",
    "masked_coordinate_median",
    "masked_trimmed_mean",
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


def _robust_out_dtype(stack: torch.Tensor) -> torch.dtype:
    """The dtype a robust rule returns: the input's, if it is a float.

    Order statistics are computed in float32, but the result is cast back so
    a bf16 arena aggregates to a bf16 model instead of widening every round.
    Integer stacks come back float32: their mean is not representable.
    """
    dt = stack.dtype
    return dt if dt.is_floating_point else torch.float32


def coordinate_median(stack: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median — a byzantine-robust aggregation rule.

    ``jnp.median``'s semantics: the mean of the two middle values for an even
    count, and NaN in every column that holds a NaN.
    """
    x = positive_nan(stack.to(torch.float32))
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    med = torch.where(torch.isnan(x).any(dim=0), torch.nan, med)
    return med.to(_robust_out_dtype(stack))


def trimmed_mean(stack: torch.Tensor, trim_k: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean dropping the ``trim_k`` extremes per side."""
    n = stack.shape[0]
    if 2 * trim_k >= n:
        raise ValueError(f"trim_k={trim_k} too large for N={n}")
    s = torch.sort(positive_nan(stack.to(torch.float32)), dim=0).values
    out = s[trim_k: n - trim_k].mean(dim=0)
    return out.to(_robust_out_dtype(stack))


def masked_coordinate_median(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """``(N, P) × (N,) × (N,) -> (P,)`` coordinate median over valid rows.

    Invalid rows are pushed to ``+inf`` by a select and one column-wise sort
    floats every valid value to the top ``n_valid`` positions, so the median
    is a gather of the two middle ranks — no re-stack, no host round trip, and
    garbage (even NaN) in a dead row never reaches the reduce.  ``weights`` is
    accepted for signature parity with :func:`masked_weighted_average` and
    ignored: order statistics are weight-blind.
    """
    del weights  # order statistics are weight-blind by design
    m = torch.as_tensor(mask).to(arena.device, torch.float32)
    rows = positive_nan(torch.where(m[:, None] > 0, arena.to(torch.float32), torch.inf))
    s = torch.sort(rows, dim=0).values
    # The middle ranks stay device tensors: no host readback of n_valid.
    n_valid = m.sum().to(torch.int64).reshape(1)
    lo = torch.clamp((n_valid - 1) // 2, min=0)
    hi = torch.clamp(n_valid // 2, min=0)
    med = (s.index_select(0, lo)[0] + s.index_select(0, hi)[0]) * 0.5
    out = torch.where(n_valid > 0, med, 0.0)
    return out.to(_robust_out_dtype(arena))


def masked_trimmed_mean(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor, trim_k: int
) -> torch.Tensor:
    """``(N, P) × (N,) × (N,) -> (P,)`` trimmed mean over valid rows.

    The surviving band is ranks ``[trim_k, n_valid - trim_k)`` of each
    column's valid values.  An impossible trim against the arena capacity is a
    ``ValueError``; a cohort that is merely *currently* too small
    (``n_valid <= 2·trim_k``) falls back to the masked mean of the valid rows.
    Reduced by ``ops.masked_trimmed_mean`` (the Hopper kernel on the card);
    ``weights`` is ignored (see :func:`masked_coordinate_median`).
    """
    n = arena.shape[0]
    if 2 * trim_k >= n:
        raise ValueError(f"trim_k={trim_k} too large for N={n}")
    out = ops.masked_trimmed_mean(arena, weights, mask, trim_k)
    return out.to(_robust_out_dtype(arena))
