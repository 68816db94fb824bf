"""Masked FedAvg over the arena: the hand-written Hopper kernel's wrappers.

Replaces the reference's TPU kernels ``repro/kernels/fedavg.py``
``masked_fedavg_pallas`` (the arena reduction, once per sync round) and
``fedavg_pallas`` (its unmasked twin, the ``store_mode="stack"`` leg).  One
CUDA kernel (``csrc/fedavg.cu``) serves both, and serves the int8 arena's
fused dequant-into-aggregate too (``kernels/fused_agg.py``) as a third row
type of the same ring; its header gives the bound (``(N·P·bytes + 4P) /
3.35 TB/s`` — HBM bandwidth) and what the design does about it.

Beside each kernel wrapper sits its plain PyTorch version, the einsum of
``repro/core/aggregation.py``: the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it on the card.

On a CUDA tensor a wrapper is one launch and nothing else: it checks its
inputs, allocates the output with ``torch.empty``, makes one ctypes call and
raises if the launch failed.  The weights are normalized inside the kernel
(every block sums them in one fixed order and applies ``normalize``'s or
``masked_normalize``'s zero-sum fallback), so no torch op runs on the
device around it.  The launch plan — a persistent grid over tiles of one
fixed width per row type, one fixed ring, the dynamic shared memory — is
computed here in Python (:func:`launch_plan`), as is the aligned-window
arithmetic of the bulk copies (:func:`tile_window`) that the kernel follows,
so the CPU tests cover both.

Each kernel wrapper counts its launches in a plain integer
(``masked_fedavg_cuda.launches``, ``fedavg_cuda.launches``), incremented only
where the kernel is launched, so a run can show it went through the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels._build import count_launch, load_library, sm_count

__all__ = [
    "normalize",
    "masked_normalize",
    "masked_fedavg_torch",
    "fedavg_torch",
    "masked_fedavg_cuda",
    "fedavg_cuda",
    "LaunchPlan",
    "launch_plan",
    "tile_window",
    "smem_bytes",
    "scale_slot_bytes",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: The launch plan, chosen by measurement on the card (PERF.md): each block
#: walks tiles of ``TILE_BYTES`` of every f32 or bf16 row (``TILE_BYTES_Q8``
#: of every int8 row: 16,384 columns, 64 accumulators a consumer thread as
#: for bf16) through a ring of ``STAGES`` one-row stages, ``BLOCKS_PER_SM``
#: blocks to an SM.  ``csrc/fedavg.cu`` refuses any other tile or stage count.
TILE_BYTES = 32768
TILE_BYTES_Q8 = 16384
STAGES = 3
BLOCKS_PER_SM = 2
#: Rows whose weights and live list are staged in shared memory; past it the
#: producer warp reads the mask and weights from global memory, tile by tile.
STAGE_CAP = 2048
#: Largest dynamic shared memory one block may take on Hopper (227 KB), the
#: shared memory of one SM (228 KB), and what the system keeps per block.
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
#: Block-wide scratch: the warp partials and the sums.
_MISC_BYTES = 512

def normalize(weights: torch.Tensor) -> torch.Tensor:
    """``w / Σw`` in f32, uniform when the weights sum to 0 (the controller's
    ``aggregation._normalize``, not ``fedavg_pallas``'s unguarded divide)."""
    w = torch.as_tensor(weights).to(torch.float32)
    total = w.sum()
    n = w.shape[0]
    safe = torch.where(total > 0, total, 1.0)
    return torch.where(total > 0, w / safe, torch.full_like(w, 1.0 / max(n, 1)))


def masked_normalize(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalize ``weights * mask``; uniform over valid rows if all zero."""
    m = torch.as_tensor(mask).to(torch.float32)
    w = torch.as_tensor(weights).to(torch.float32) * m
    total = w.sum()
    uniform = m / torch.clamp(m.sum(), min=1.0)
    return torch.where(total > 0, w / torch.where(total > 0, total, 1.0), uniform)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card yardstick)
# ---------------------------------------------------------------------------


def masked_fedavg_torch(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """``(N, P) × (N,) × (N,) -> (P,)`` masked weighted mean, plain torch.

    Dead rows are zeroed by ``where`` *before* the multiply, so a NaN in a
    row that never reported cannot produce ``0 * NaN = NaN``.
    """
    m = mask.to(torch.float32)
    w = masked_normalize(weights, m)
    rows = torch.where(m[:, None] > 0, arena.to(torch.float32), 0.0)
    return torch.einsum("n,np->p", w, rows)


def fedavg_torch(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(N, P) × (N,) -> (P,)`` normalized weighted mean, plain torch."""
    return torch.einsum("n,np->p", normalize(weights), stack.to(torch.float32))


# ---------------------------------------------------------------------------
# The launch plan and the bulk copies' windows (mirrored by csrc/fedavg.cu)
# ---------------------------------------------------------------------------


class Window(NamedTuple):
    """One row's bytes of one tile: ``[a, b)`` split into three parts.

    ``[a, head_end)`` and ``[tail_start, b)`` are under 16 bytes each and
    are read with plain loads; ``[src, src + nbytes)`` is the bulk copy, a
    16-byte-aligned window landing ``dst`` bytes into the row's ring slot
    (``TILE_BYTES + 128`` bytes).
    Column ``c0 + j`` sits ``delta + j·esize`` bytes into the slot.
    """

    a: object
    b: object
    src: object
    nbytes: object
    dst: object
    delta: object
    head_end: object
    tail_start: object


def tile_window(base, esize, row_stride, n, p, row, c0, c1) -> Window:
    """The aligned window of ``row``'s columns ``[c0, c1)``; numpy-vectorized.

    ``base`` is the tensor's ``data_ptr()``, ``row_stride`` in elements.  The
    window is the tile's byte range with its start rounded down to 128 bytes
    and its end up to 16, clipped to the view's extent
    ``[base, base + ((n-1)·row_stride + p)·esize)`` so no copy reads before
    the first row's first byte or past the last row's last one.  What the
    clip cuts off is the head or tail edge.  The slot's first byte stands
    for the address ``a`` rounded down to 128, so an unclipped copy's source
    and destination are both 128-byte aligned.  ``csrc/fedavg.cu``'s
    ``tile_window`` is the same arithmetic.
    """
    lo = base
    hi = base + ((n - 1) * row_stride + p) * esize
    a = base + (row * row_stride + c0) * esize
    b = base + (row * row_stride + c1) * esize
    origin = a & ~127
    ws = np.maximum(origin, (lo + 15) & ~15)
    we = np.maximum(np.minimum((b + 15) & ~15, hi & ~15), ws)
    return Window(a=a, b=b, src=ws, nbytes=we - ws, dst=ws - origin, delta=a - origin,
                  head_end=np.clip(ws, a, b), tail_start=np.clip(we, a, b))


def scale_slot_bytes(group: int) -> int:
    """One stage's scale slot for int8 rows (``csrc/fedavg.cu``'s
    ``scale_slot_bytes``): the groups a tile's columns touch, at most
    ``ceil(TILE_BYTES_Q8 / group) + 1``, 4 bytes each, in a multiple of 128
    bytes, plus the 128 a window may start early."""
    return 128 + -(-4 * (-(-TILE_BYTES_Q8 // group) + 1) // 128) * 128


def smem_bytes(n: int, staged: bool, group: int | None = None) -> int:
    """Dynamic shared memory of one block (``csrc/fedavg.cu``'s ``Layout``):
    the ring (``STAGES`` slots of the tile plus 128 bytes), for int8 rows
    (``group`` given) a scale slot per stage, each slot's weight, byte offset
    and (int8) scale byte offset, a full and an empty barrier per stage at an
    8-byte boundary, the misc scratch and, when staged, ŵ and the live list
    (4 bytes a row each)."""
    tile = TILE_BYTES if group is None else TILE_BYTES_Q8
    sslot = 0 if group is None else scale_slot_bytes(group)
    offsets = STAGES * (tile + 128) + STAGES * sslot + STAGES * 8 + (STAGES * 4 if sslot else 0)
    bars = -(-offsets // 8) * 8
    return bars + STAGES * 16 + _MISC_BYTES + (8 * n if staged else 0)


class LaunchPlan(NamedTuple):
    """How ``repro_fedavg`` is launched (see :func:`launch_plan`)."""

    grid: int
    staged: bool
    smem_bytes: int
    n_tiles: int


def _sm_count(device: torch.device) -> int:
    return sm_count(device.index if device.index is not None else torch.cuda.current_device())


def launch_plan(rows: torch.Tensor, *, sm_count: int | None = None,
                group: int | None = None) -> LaunchPlan:
    """The launch plan for an ``(N, P)`` arena: its tiles per row
    (``TILE_BYTES``, or ``TILE_BYTES_Q8`` for int8 rows, whose scale
    ``group`` must be given), whether ŵ and the live list are staged in
    shared memory (``N <= STAGE_CAP``), the block's dynamic shared memory,
    and a persistent grid of the fewest blocks that take as many rounds over
    the tiles as ``BLOCKS_PER_SM`` blocks on every SM would, so the last
    round is as full as the first.  ``sm_count`` defaults to the card's (pass
    it for a host tensor)."""
    n, p = rows.shape
    if (rows.dtype == torch.int8) != (group is not None):
        raise ValueError("int8 rows need their scale group, and only they take one")
    if sm_count is None:
        sm_count = _sm_count(rows.device)
    staged = n <= STAGE_CAP
    tile = TILE_BYTES if group is None else TILE_BYTES_Q8
    n_tiles = -(-p // (tile // rows.element_size()))
    rounds = -(-n_tiles // (sm_count * BLOCKS_PER_SM))
    grid = -(-n_tiles // rounds) if rounds else 0
    return LaunchPlan(grid=grid, staged=staged, smem_bytes=smem_bytes(n, staged, group),
                      n_tiles=n_tiles)


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------


def _vector(x, n: int, dev: torch.device, what: str) -> torch.Tensor:
    """An ``(n,)`` f32 vector on ``dev``; moved there only if it is not
    already (the controller's weights and mask are)."""
    t = torch.as_tensor(x)
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        t = t.to(dev, torch.float32).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{what} must be ({n},), got {tuple(t.shape)}")
    return t


def _out(out: torch.Tensor | None, p: int, dev: torch.device, align: int) -> torch.Tensor:
    """The ``(p,)`` f32 output on ``dev``: a new one, or the caller's ``out``
    (a contiguous f32 ``(p,)`` tensor on ``dev`` whose start is
    ``align``-byte aligned, such as a window of a larger row)."""
    if out is None:
        return torch.empty((p,), dtype=torch.float32, device=dev)
    if (tuple(out.shape) != (p,) or out.dtype != torch.float32 or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({p},) tensor on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if out.data_ptr() % align:
        raise ValueError(f"out must start {align}-byte aligned")
    return out


def _launch(rows: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor | None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Check the inputs, launch ``repro_fedavg`` on the current stream.

    ``weights`` are raw: the kernel normalizes them.  ``out`` (optional) is
    written in place: it must start 16-byte aligned, as the kernel's stores are.
    """
    if rows.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {rows.device}")
    if rows.ndim != 2:
        raise ValueError(f"expected an (N, P) arena, got shape {tuple(rows.shape)}")
    code = _DTYPE_CODES.get(rows.dtype)
    if code is None:
        raise ValueError(f"arena rows must be float32 or bfloat16, got {rows.dtype}")
    n, p = rows.shape
    if n < 1:
        raise ValueError("the arena needs at least one row")
    if rows.stride(1) != 1 or rows.stride(0) < p:
        raise ValueError("arena rows must be contiguous along P (stride(1) == 1)")
    dev = rows.device
    w = _vector(weights, n, dev, "weights")
    m = None if mask is None else _vector(mask, n, dev, "mask")
    plan = launch_plan(rows)
    out = _out(out, p, dev, 16)
    lib = load_library().lib
    with torch.cuda.device(dev):
        rc = lib.repro_fedavg(
            rows.data_ptr(), code, rows.stride(0), w.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr(), n, p,
            plan.grid, TILE_BYTES, STAGES, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"repro_fedavg launch failed with cudaError {rc}")
    return out


def masked_fedavg_cuda(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked FedAvg on the card through the hand-written kernel, one launch.

    Reads the arena in place at its padded width; the caller slices
    ``[:num_params]``.  Writes into ``out`` when given (16-byte aligned).
    Raises on a non-CUDA tensor or a failed launch.
    """
    out = _launch(arena, weights, mask, out)
    count_launch(masked_fedavg_cuda)
    return out


def fedavg_cuda(stack: torch.Tensor, weights: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Unmasked FedAvg on the card through the same kernel (no mask)."""
    out = _launch(stack, weights, None, out)
    count_launch(fedavg_cuda)
    return out


masked_fedavg_cuda.launches = 0
fedavg_cuda.launches = 0
