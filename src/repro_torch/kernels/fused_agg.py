"""Fused dequant-into-aggregate over the int8 arena: the kernel's wrappers.

Replaces the reference's TPU kernel ``repro/kernels/fused_agg.py``
``masked_fedavg_q8_pallas``: the quantized-resident arena
(``core/store.ArenaStore(arena_dtype="int8")``) keeps each learner row as
int8 groups plus per-group f32 scales, and its aggregation reads them in one
pass, never building the f32 ``(N, P)`` stack.  The CUDA kernel is the
masked FedAvg kernel's ring (``csrc/fedavg.cu``) with a third row type, int8
values and their scale tile: one launch per aggregate with the weights
normalized inside (ŵ bit for bit as ``masked_fedavg_cuda`` derives it), a
persistent grid over 16 KB column tiles, and one producer lane that issues a
``cp.async.bulk`` copy of each live row's int8 tile and one of its scales
into a 3-stage ring in shared memory, so dead rows are never read.  Each
value is dequantized and rounded before its FMA, as in the reference, so the
result equals ``masked_fedavg_cuda(dequant_rows(q, s), w, m)`` bit for bit.
The bound is HBM bandwidth over the live rows' bytes, ``(L·P + 4·L·P/group
+ 4P) / 3.35 TB/s`` for L live rows: 0.1109 ms at 32 live rows of
10,174,464 columns at group 256, 0.0368 ms at 8 of 32.  Rows may be strided
and unaligned (aligned windows, as for FedAvg); nothing is copied.  The TPU
block-size helpers (``choose_block_p_q8*``) size VMEM tiles and have no
counterpart here: every ``P`` that is a whole number of groups runs as is.

Beside the kernel wrapper sits its plain PyTorch version, the reference's
``aggregation.masked_fedavg_q8`` (dequantize, ``where``, einsum): the CPU
tests run it, and ``chip_smoke.py`` holds the kernel against it on the card.
``masked_fedavg_q8_cuda.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels._build import count_launch, load_library
from repro_torch.kernels.quantize import DEFAULT_GROUP

__all__ = ["dequant_rows", "masked_fedavg_q8_torch", "masked_fedavg_q8_cuda"]


def _check(q: torch.Tensor, scales: torch.Tensor, group: int) -> tuple[int, int]:
    if q.ndim != 2:
        raise ValueError(f"expected an (N, P) int8 arena, got shape {tuple(q.shape)}")
    n, p = q.shape
    if group < 8 or group % 8 or p % group:
        raise ValueError(f"P={p} must be a whole number of groups of {group} (a multiple of 8)")
    if tuple(scales.shape) != (n, p // group):
        raise ValueError(
            f"scales shape {tuple(scales.shape)} does not match {n} rows of "
            f"{p}//{group}={p // group} groups"
        )
    return n, p


def dequant_rows(q: torch.Tensor, scales: torch.Tensor, group: int = DEFAULT_GROUP) -> torch.Tensor:
    """Dequantize ``(N, P)`` int8 rows with ``(N, P//group)`` f32 scales."""
    n, p = q.shape
    return (q.to(torch.float32).reshape(n, p // group, group)
            * scales.to(torch.float32)[:, :, None]).reshape(n, p)


def masked_fedavg_q8_torch(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
    group: int = DEFAULT_GROUP,
) -> torch.Tensor:
    """``(N, P)`` int8 × ``(N, P//group)`` × ``(N,)`` × ``(N,)`` -> ``(P,)``, plain torch.

    Dead rows are zeroed by ``where`` before the multiply, so a NaN or 1e30
    scale in a row that never reported cannot leak.
    """
    _check(q, scales, group)
    m = mask.to(torch.float32)
    w = _fedavg.masked_normalize(weights, m)
    rows = torch.where(m[:, None] > 0, dequant_rows(q, scales, group), 0.0)
    return torch.einsum("n,np->p", w, rows)


def masked_fedavg_q8_cuda(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
    group: int = DEFAULT_GROUP, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The fused dequant-into-aggregate on the card through the hand-written
    kernel, one launch.

    Reads the arena and its scales in place (rows may be strided, at any
    alignment); ``weights`` are raw (the kernel normalizes them).  Raises on
    a non-CUDA tensor, a non-int8 arena, a bad shape or layout, or a failed
    launch.  Writes into ``out`` when given (16-byte aligned).
    """
    if q.dtype != torch.int8:
        raise ValueError(f"the quantized arena must be int8, got {q.dtype}")
    n, p = _check(q, scales, group)
    if n < 1:
        raise ValueError("the arena needs at least one row")
    if q.stride(1) != 1 or q.stride(0) < p:
        raise ValueError("arena rows must be contiguous along P (stride(1) == 1)")
    dev = q.device
    if scales.device != dev or scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32 on {dev}, got {scales.dtype} on {scales.device}")
    if scales.stride(1) != 1 or scales.stride(0) < p // group:
        raise ValueError("scale rows must be contiguous (stride(1) == 1)")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {dev}")
    w = _fedavg._vector(weights, n, dev, "weights")
    m = _fedavg._vector(mask, n, dev, "mask")
    plan = _fedavg.launch_plan(q, group=group)
    out = _fedavg._out(out, p, dev, 16)
    lib = load_library().lib
    with torch.cuda.device(dev):
        rc = lib.repro_fedavg_q8(
            q.data_ptr(), q.stride(0), scales.data_ptr(), scales.stride(0),
            w.data_ptr(), m.data_ptr(), out.data_ptr(), n, p, group,
            plan.grid, _fedavg.TILE_BYTES_Q8, _fedavg.STAGES, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"repro_fedavg_q8 launch failed with cudaError {rc}")
    count_launch(masked_fedavg_q8_cuda)
    return out


masked_fedavg_q8_cuda.launches = 0
