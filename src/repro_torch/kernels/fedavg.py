"""Masked FedAvg over the arena: the hand-written Hopper kernel's wrappers.

Replaces the reference's TPU kernels ``repro/kernels/fedavg.py``
``masked_fedavg_pallas`` (the arena reduction, once per sync round) and
``fedavg_pallas`` (its unmasked twin, the ``store_mode="stack"`` leg).  One
CUDA kernel (``csrc/fedavg.cu``) serves both; its header gives the bound
(``(N·P·bytes + 4P) / 3.35 TB/s`` — HBM bandwidth) and what the design does
about it.

Beside each kernel wrapper sits its plain PyTorch version, the einsum of
``repro/core/aggregation.py``: the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it on the card.  The normalized ``(N,)`` weight
vector is computed here with torch ops on the tensor's device, as the
reference's wrapper does; the kernel does the ``(N, P)`` pass.

Each kernel wrapper counts its launches in a plain integer
(``masked_fedavg_cuda.launches``, ``fedavg_cuda.launches``), incremented only
where the kernel is launched, so a run can show it went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import count_launch, load_library
__all__ = [
    "normalize",
    "masked_normalize",
    "masked_fedavg_torch",
    "fedavg_torch",
    "masked_fedavg_cuda",
    "fedavg_cuda",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
# Hopper kernel wrappers
# ---------------------------------------------------------------------------


def _launch(rows: torch.Tensor, w_hat: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Check the inputs, launch ``repro_fedavg`` on the current stream."""
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
    w_hat = w_hat.to(rows.device, torch.float32).contiguous()
    if w_hat.shape != (n,):
        raise ValueError(f"weights must be ({n},), got {tuple(w_hat.shape)}")
    if mask is not None:
        mask = mask.to(rows.device, torch.float32).contiguous()
        if mask.shape != (n,):
            raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")
    out = torch.empty((p,), dtype=torch.float32, device=rows.device)
    lib = load_library().lib
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.repro_fedavg(
            rows.data_ptr(), code, rows.stride(0), w_hat.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            n, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"repro_fedavg launch failed with cudaError {rc}")
    return out


def masked_fedavg_cuda(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked FedAvg on the card through the hand-written kernel.

    Reads the arena in place at its padded width; the caller slices
    ``[:num_params]``.  Raises on a non-CUDA tensor or a failed launch.
    """
    dev = arena.device
    m = torch.as_tensor(mask).to(dev, torch.float32)
    out = _launch(arena, masked_normalize(torch.as_tensor(weights).to(dev), m), m)
    count_launch(masked_fedavg_cuda)
    return out


def fedavg_cuda(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Unmasked FedAvg on the card through the same kernel (no mask)."""
    out = _launch(stack, normalize(torch.as_tensor(weights).to(stack.device)), None)
    count_launch(fedavg_cuda)
    return out


masked_fedavg_cuda.launches = 0
fedavg_cuda.launches = 0
