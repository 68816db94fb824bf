"""Masked scatter-accumulate: weighted sparse rows into one dense row.

The port of ``repro/kernels/sparse_agg.py::scatter_accumulate``, the sparse
arena's reduce.  Each valid arena row is a ``(k,)`` stream of
``(index, value)`` pairs; the reduce scatters every stream's weighted values
into a ``(P,)`` f32 accumulator, so it moves ``~N·k + P`` floats instead of
the dense ``N·P``.  The reference's reduce is one XLA scatter-add, not a
Pallas kernel, and the port's is torch's ``index_add_``: no hand kernel is
owed.

Determinism: one ``index_add_`` over all ``N·k`` pairs would make colliding
indices race as atomics on the card, in an order that changes from run to
run.  Indices are unique within a row (top-k output), so the port adds one
row at a time, in row order: each launch touches every slot at most once,
so no two atomics meet, the result is the same bits on every run, and each
column is summed in the order of the reference's serial scatter on the host.

Invalid rows are masked with a ``where`` before the weight multiply, so NaN
or garbage in a never-written row cannot reach the sum.  Their zero
contributions go to slots ``0..k-1`` (the reference sends them all to slot
0, which on the card would be ``k`` atomics on one address): the sum starts
at ``+0.0`` and so never holds ``-0.0``, and adding ``+0.0`` leaves every
other value as it is, so the result is the reference's bits either way.
The column-sharded variant is slice G of the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.topk import flush_subnormal

__all__ = ["scatter_accumulate", "scatter_accumulate_sharded"]


def scatter_accumulate(
    indices: torch.Tensor,
    values: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    out_width: int,
) -> torch.Tensor:
    """Sum masked, weighted sparse rows into a dense ``(out_width,)`` f32 row.

    ``indices``/``values`` are the ``(N, k)`` sparse arena; ``weights`` the
    ``(N,)`` *normalized* weights (zero at masked rows); ``mask`` the ``(N,)``
    validity mask.  Within a row the indices are unique; across rows they
    collide freely and the adds combine them into the weighted sum.
    """
    live = torch.as_tensor(mask).to(values.device, torch.float32)[:, None] > 0
    contrib = torch.where(live, values, 0.0).to(torch.float32)
    contrib = flush_subnormal(contrib * weights.to(values.device, torch.float32)[:, None])
    spread = torch.arange(indices.shape[1], device=indices.device, dtype=indices.dtype)
    idx = torch.where(live, indices, spread).to(torch.int64)
    out = torch.zeros((out_width,), dtype=torch.float32, device=values.device)
    for row in range(idx.shape[0]):
        out.index_add_(0, idx[row], contrib[row])
    return out


def scatter_accumulate_sharded(mesh, axes, out_width: int):
    """The column-sharded scatter-accumulate: slice G of the port."""
    raise NotImplementedError(
        "scatter_accumulate_sharded is not ported yet: the column-sharded arena is "
        "slice G of the port (ROADMAP.md)"
    )
