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
The column-sharded variant (:func:`scatter_accumulate_sharded`) gives each
slot of the mesh the whole ``(N, k)`` arena and lets it add, row by row in
the same order, only the coordinates that fall in its own column window:
every column sees the same adds in the same order as in the one-device
scatter, so the result is the same bits.
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
    """Build a column-sharded scatter-accumulate over ``mesh``.

    The returned function has :func:`scatter_accumulate`'s signature minus
    ``out_width``.  Its inputs are whole (the sparse arena is ``N·k``-small by
    construction); its ``(out_width,)`` output is split over ``axes``, one
    window of ``out_width / n_shards`` columns a slot.  Each slot takes its
    linearized slot id (row-major over ``axes``, the layout's order), rebases
    the global indices into its window ``[sid·w, (sid+1)·w)`` and adds only
    the coordinates inside it, one row at a time; the others add ``+0.0`` to
    a spread of its own slots, which changes no bit.  A slot on the output's
    device adds straight into its window of the result; the result lies on
    the mesh's first slot device.
    """
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    devices = mesh.slot_devices(axes_t)
    n_shards = len(devices)
    if out_width % n_shards != 0:
        raise ValueError(f"out_width {out_width} not divisible by {n_shards} shards")
    local_w = out_width // n_shards
    home = devices[0]

    def _scatter(indices, values, weights, mask):
        live = torch.as_tensor(mask).to(values.device, torch.float32)[:, None] > 0
        contrib = torch.where(live, values, 0.0).to(torch.float32)
        contrib = flush_subnormal(contrib * weights.to(values.device, torch.float32)[:, None])
        out = torch.zeros((out_width,), dtype=torch.float32, device=home)
        k = indices.shape[1]
        for sid, dev in enumerate(devices):
            window = out[sid * local_w: (sid + 1) * local_w]
            local = indices.to(dev, torch.int64) - sid * local_w
            ok = (local >= 0) & (local < local_w) & live.to(dev)
            spread = torch.arange(k, device=dev, dtype=torch.int64) % max(local_w, 1)
            idx = torch.where(ok, local, spread)
            add = torch.where(ok, contrib.to(dev), 0.0)
            acc = window if dev == home else torch.zeros((local_w,), dtype=torch.float32,
                                                         device=dev)
            for row in range(idx.shape[0]):
                acc.index_add_(0, idx[row], add[row])
            if acc is not window:
                window.copy_(acc)
        return out

    return _scatter
