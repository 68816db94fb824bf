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
fused dequant-into-aggregate kernel on the card (``kernels/csrc/fedavg.cu``'s
int8 row type), the plain dequantize-``where``-einsum on the host.

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

The top-k rules (:func:`masked_fedavg_topk`, :func:`masked_staleness_topk`)
reduce the sparse arena's ``(N, k)`` index/value rows through
``kernels/sparse_agg.scatter_accumulate``: an XLA scatter in the reference,
torch's ``index_add_`` one row at a time here, deterministic on the card.

The ``*_sharded`` variants reduce a column-sharded arena
(``core/store.ArenaStore(mesh=...)``) laid out on a slot mesh
(``launch/mesh.make_controller_mesh``): each returns a function with the
reference's signature that runs the one-device rule once per slot, on the
slot's ``(n_max, P/n_shards)`` shard, and assembles the ``(P,)`` result once,
on the mesh's first slot device (``kernels/ops.per_slot``).  The reference's
are ``jax.jit``s with column shardings and zero collectives; here too no data
crosses slots inside a reduce.  Every rule is per column and the weight
normalization reads only the replicated ``(n_max,)`` vectors, so a sharded
result equals the one-device result.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, sparse_agg
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
    "masked_fedavg_topk",
    "masked_staleness_topk",
    "staleness_weights",
    "coordinate_median",
    "trimmed_mean",
    "masked_coordinate_median",
    "masked_trimmed_mean",
    "arena_axes",
    "fedavg_sharded",
    "masked_fedavg_sharded",
    "masked_fedavg_q8_sharded",
    "masked_staleness_q8_sharded",
    "masked_fedavg_topk_sharded",
    "masked_staleness_topk_sharded",
    "masked_staleness_sharded",
    "masked_median_sharded",
    "masked_trimmed_mean_sharded",
    "hierarchical_fedavg",
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


def masked_fedavg_topk(
    indices: torch.Tensor,
    values: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    out_width: int,
) -> torch.Tensor:
    """Masked FedAvg straight off a sparse (top-k) arena — scatter, not stack.

    ``(N, k)`` int32 × ``(N, k)`` f32 × ``(N,)`` × ``(N,)`` -> ``(out_width,)``:
    the weights are normalized over the valid rows, then every valid row's
    weighted ``(index, value)`` stream is scattered into the dense output, so
    the ``(N, P)`` stack is never built.  Rows hold *deltas*; the controller
    adds the aggregated delta onto the global buffer at commit.
    """
    m = torch.as_tensor(mask).to(values.device, torch.float32)
    w = masked_normalize(weights, m)
    return sparse_agg.scatter_accumulate(indices, values, w, m, out_width)


def masked_staleness_topk(
    indices: torch.Tensor,
    values: torch.Tensor,
    num_examples: torch.Tensor,
    versions: torch.Tensor,
    current_version: float,
    mask: torch.Tensor,
    out_width: int,
    alpha: float = 0.5,
) -> torch.Tensor:
    """Staleness-damped masked scatter-accumulate over a sparse arena.

    The sparse statement of :func:`masked_staleness_average`: the staleness
    discount damps the ``(N,)`` weights, then one masked scatter-accumulate
    folds every valid sparse row into the ``(out_width,)`` delta.
    """
    m = torch.as_tensor(mask).to(values.device, torch.float32)
    stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
    w = masked_normalize(staleness_weights(num_examples, stal, alpha), m)
    return sparse_agg.scatter_accumulate(indices, values, w, m, out_width)


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


# ---------------------------------------------------------------------------
# Column-sharded aggregation
# ---------------------------------------------------------------------------


def arena_axes(mesh, axes=None) -> tuple[str, ...]:
    """The arena's column-sharding axes on ``mesh``, always a tuple.

    The default is the ``"data"`` axis if the mesh has one, else every axis;
    shared by ``models.sharding.arena_specs`` (the store's layout) and every
    sharded reduction below, so the two cannot disagree.  (The reference's
    store reads the axes back from its row sharding's spec, where a single
    axis is a bare string, and then iterates its letters: ``KeyError: 'd'``.)
    """
    if axes is None:
        return ("data",) if "data" in mesh.axis_names else tuple(mesh.axis_names)
    return (axes,) if isinstance(axes, str) else tuple(axes)


def fedavg_sharded(mesh, stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """FedAvg of an ``(N, P)`` stack split along ``P`` over *all* mesh axes.

    Every slot reduces its own parameter window (kernel 2 on the card): one
    worker per shard, the generalization of MetisFL's one thread per tensor.
    """
    return ops.per_slot(ops.fedavg, mesh, tuple(mesh.axis_names))(stack, weights)


def masked_fedavg_sharded(mesh, axes=None):
    """Masked FedAvg over a column-sharded arena, one reduce a slot.

    Returns ``(arena (N_max, P), weights (N_max,), mask (N_max,)) -> (P,)``;
    per slot exactly :func:`masked_weighted_average` (kernel 1 on the card).
    """
    return ops.masked_fedavg_sharded(mesh, arena_axes(mesh, axes))


def masked_fedavg_q8_sharded(mesh, axes=None, group: int = 256):
    """Masked FedAvg over a column-sharded quantized arena, one fused reduce a
    slot: ``(q (N, P) int8, scales (N, P//group), weights, mask) -> (P,)``."""
    return ops.masked_fedavg_q8_sharded(mesh, arena_axes(mesh, axes), group)


def masked_staleness_q8_sharded(mesh, axes=None, alpha: float = 0.5, group: int = 256):
    """Sharded :func:`masked_staleness_q8`: ``(q, scales, num_examples,
    versions, current_version, mask) -> (P,)``; the staleness discount runs
    once on the ``(N,)`` vectors, the fused reduce once a slot."""
    reduce = ops.masked_fedavg_q8_sharded(mesh, arena_axes(mesh, axes), group)

    def _agg(q, scales, num_examples, versions, current_version, mask):
        stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
        return reduce(q, scales, staleness_weights(num_examples, stal, alpha), mask)

    return _agg


def masked_fedavg_topk_sharded(mesh, axes=None, out_width: int = 0):
    """Masked sparse FedAvg into a column-sharded output.

    Returns ``(indices (N, k) int32, values (N, k) f32, weights (N,), mask
    (N,)) -> (out_width,)``.  The sparse arena's inputs stay whole (``N·k``
    is small by construction); each slot scatters the coordinates that fall
    in its own window (``kernels/sparse_agg.scatter_accumulate_sharded``).
    """
    scatter = sparse_agg.scatter_accumulate_sharded(mesh, arena_axes(mesh, axes),
                                                     int(out_width))

    def _agg(indices, values, weights, mask):
        m = torch.as_tensor(mask).to(values.device, torch.float32)
        return scatter(indices, values, masked_normalize(weights, m), m)

    return _agg


def masked_staleness_topk_sharded(mesh, axes=None, out_width: int = 0,
                                  alpha: float = 0.5):
    """Sharded :func:`masked_staleness_topk`: the staleness discount on the
    ``(N,)`` vectors, then the column-sharded scatter."""
    scatter = sparse_agg.scatter_accumulate_sharded(mesh, arena_axes(mesh, axes),
                                                     int(out_width))

    def _agg(indices, values, num_examples, versions, current_version, mask):
        m = torch.as_tensor(mask).to(values.device, torch.float32)
        stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
        return scatter(indices, values,
                       masked_normalize(staleness_weights(num_examples, stal, alpha), m), m)

    return _agg


def masked_staleness_sharded(mesh, axes=None, alpha: float = 0.5):
    """Sharded :func:`masked_staleness_average`: ``(arena, num_examples,
    versions, current_version, mask) -> (P,)``; the staleness discount on the
    ``(N_max,)`` vectors, then kernel 1 once a slot."""
    reduce = ops.masked_fedavg_sharded(mesh, arena_axes(mesh, axes))

    def _agg(arena, num_examples, versions, current_version, mask):
        stal = torch.clamp(float(current_version) - versions.to(torch.float32), min=0.0)
        return reduce(arena, staleness_weights(num_examples, stal, alpha), mask)

    return _agg


def masked_median_sharded(mesh, axes=None):
    """Masked coordinate median over a column-sharded arena: each slot sorts
    its own columns (:func:`masked_coordinate_median`, ``torch.sort``)."""

    def _local(arena, weights, mask, out=None):
        return masked_coordinate_median(arena, weights, mask)

    return ops.per_slot(_local, mesh, arena_axes(mesh, axes))


def masked_trimmed_mean_sharded(mesh, axes=None, trim_k: int = 1):
    """Masked trimmed mean over a column-sharded arena: kernel 6 once a slot;
    an impossible trim raises :func:`masked_trimmed_mean`'s ``ValueError``."""
    reduce = ops.masked_trimmed_mean_sharded(mesh, arena_axes(mesh, axes), trim_k)

    def _agg(arena, weights, mask):
        n = arena.shape[0]
        if 2 * trim_k >= n:
            raise ValueError(f"trim_k={trim_k} too large for N={n}")
        return reduce(arena, weights, mask).to(_robust_out_dtype(arena))

    return _agg


def hierarchical_fedavg(mesh, pod_axis: str = "pod"):
    """Beyond-paper: aggregation over the ``pod`` axis of a slot mesh.

    Each pod is a learner silo: row ``i`` of the ``(n_pods, P)`` stack lives
    on pod ``i``'s slots, column-windowed over the other axes.  Returns
    ``(stack (n_pods, P), weights (n_pods,)) -> (P,)``: in every window each
    pod's row is weighted, the rows are summed across pods in pod order (the
    reference's ``psum``) and divided by ``max(Σw, 1e-12)``.
    """
    from repro_torch.models.sharding import windows

    if pod_axis not in mesh.axis_names:
        raise ValueError(f"axis {pod_axis!r} is not one of the mesh's {mesh.axis_names}")
    names = list(mesh.axis_names)
    grid = np.moveaxis(mesh.devices, names.index(pod_axis), 0)
    n_pods = grid.shape[0]
    grid = grid.reshape(n_pods, -1)  # [pod, window], windows row-major over the rest

    def agg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        if stack.shape[0] != n_pods:
            raise ValueError(f"a stack of {stack.shape[0]} rows for {n_pods} pods")
        w = torch.as_tensor(weights).to(torch.float32)
        wsum = torch.clamp(w.sum(), min=1e-12)
        home = grid[0, 0]
        out = torch.empty((stack.shape[1],), dtype=torch.float32, device=home)
        for j, (a, b) in enumerate(windows(stack.shape[1], grid.shape[1])):
            dev = grid[0, j]
            total = None
            for i in range(n_pods):
                contrib = (stack[i, a:b].to(grid[i, j]).to(torch.float32)
                           * w[i].to(grid[i, j])).to(dev)
                total = contrib if total is None else total + contrib
            out[a:b].copy_(total / wsum.to(dev))
        return out

    return agg
