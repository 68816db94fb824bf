"""Masked trimmed mean over the arena: the hand-written Hopper kernel's wrapper.

Replaces the reference's TPU kernel ``repro/kernels/robust.py``
``masked_trimmed_mean_pallas`` (the byzantine-robust reduction, once per
sync round under ``aggregation_rule="trimmed_mean"``).  The CUDA kernel
(``csrc/robust.cu``) sorts each column in registers with Batcher's odd-even
merge network for ``N <= 64`` and sums the band in sorted order; past 64
rows it rank-selects.  Its header gives the bound (the bytes) and what the
design does about it.  :func:`sorting_network` is the network's loop nest
as the CUDA template runs it, so the CPU tests pin its compare-exchanges
where no card is present.  The TPU tiling helpers (the VMEM block choice and
the pad in the reference's ``ops.py``) are not ported: the kernel takes any
``P``.

Beside the kernel wrapper sits its plain PyTorch version, the sort-then-trim
of ``repro/kernels/ref.py``: the CPU path, and the yardstick ``chip_smoke.py``
holds the kernel against on the card.  Both sum the band in sorted order, up
to the torch reduction's own grouping (the rank-select past 64 rows sums in
row order), so they agree to float rounding, not bit for bit.

The kernel wrapper counts its launches in a plain integer
(``masked_trimmed_mean_cuda.launches``), incremented only where the kernel is
launched.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels._build import count_launch, load_library

__all__ = ["sorting_network", "positive_nan", "masked_trimmed_mean_torch",
           "masked_trimmed_mean_cuda"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sorting_network(np_: int) -> list[tuple[int, int]]:
    """Batcher's odd-even merge sort on ``np_`` (a power of two) inputs: its
    compare-exchanges ``(lo, hi)`` in order, by the loop nest of
    ``csrc/robust.cu``'s ``network_walk`` (each puts the smaller value at
    ``lo``)."""
    pairs = []
    p = 1
    while p < np_:
        k = p
        while k >= 1:
            for j in range(k % p, np_ - k, 2 * k):
                for i in range(min(k, np_ - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def positive_nan(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN replaced by the positive quiet NaN.

    ``torch.sort`` on the card puts a NaN with its sign bit set first and a
    positive one last; on the host, and in the reference's ``jnp.sort``,
    every NaN sorts last.  Canonicalizing before a sort makes both devices
    order a column alike.  NaN-free inputs come back bit for bit.
    """
    return torch.where(torch.isnan(x), torch.nan, x)


def _check_trim(trim_k: int, n: int) -> None:
    """The reference kernel's trace-time check: ``0 <= trim_k``, ``2·trim_k < N``."""
    if trim_k < 0 or 2 * trim_k >= n:
        raise ValueError(f"trim_k={trim_k} invalid for N={n}")


def masked_trimmed_mean_torch(
    arena: torch.Tensor, mask: torch.Tensor, trim_k: int
) -> torch.Tensor:
    """``(N, P) × (N,) -> (P,)`` trimmed mean over valid rows, f32, plain torch.

    Sort-then-trim: invalid rows float to ``+inf`` by a select, so garbage
    (even NaN) in a dead row never reaches the sum; the surviving band is
    ranks ``[trim_k, n_valid - trim_k)``; a degenerate cohort
    (``n_valid <= 2·trim_k``) falls back to the untrimmed masked mean, and
    no valid row gives 0.  Every NaN sorts last, on the card as on the host
    (:func:`positive_nan`).
    """
    n = arena.shape[0]
    _check_trim(trim_k, n)
    m = torch.as_tensor(mask).to(arena.device, torch.float32)
    x = arena.to(torch.float32)
    live = m[:, None] > 0
    s = torch.sort(positive_nan(torch.where(live, x, torch.inf)), dim=0).values
    n_valid = m.sum().to(torch.int32)
    ranks = torch.arange(n, device=arena.device, dtype=torch.int32)
    band = (ranks >= trim_k) & (ranks < n_valid - trim_k)
    count = band.to(torch.float32).sum()
    trimmed = torch.where(band[:, None], s, 0.0).sum(0) / torch.clamp(count, min=1.0)
    fallback = torch.where(live, x, 0.0).sum(0) / torch.clamp(m.sum(), min=1.0)
    return torch.where(count > 0, trimmed, torch.where(n_valid > 0, fallback, 0.0))


def masked_trimmed_mean_cuda(
    arena: torch.Tensor, mask: torch.Tensor, trim_k: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Masked trimmed mean on the card through the hand-written kernel.

    Reads the arena in place at its padded width (row stride passed in); the
    caller slices ``[:num_params]``.  Writes into ``out`` when given.  Raises
    on a non-CUDA tensor, an unsupported dtype or layout, an impossible
    ``trim_k`` or a failed launch.
    """
    if arena.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {arena.device}")
    if arena.ndim != 2:
        raise ValueError(f"expected an (N, P) arena, got shape {tuple(arena.shape)}")
    code = _DTYPE_CODES.get(arena.dtype)
    if code is None:
        raise ValueError(f"arena rows must be float32 or bfloat16, got {arena.dtype}")
    n, p = arena.shape
    if n < 1:
        raise ValueError("the arena needs at least one row")
    if arena.stride(1) != 1 or arena.stride(0) < p:
        raise ValueError("arena rows must be contiguous along P (stride(1) == 1)")
    _check_trim(trim_k, n)
    m = torch.as_tensor(mask).to(arena.device, torch.float32).contiguous()
    if m.shape != (n,):
        raise ValueError(f"mask must be ({n},), got {tuple(m.shape)}")
    out = _fedavg._out(out, p, arena.device, 4)
    lib = load_library().lib
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        rc = lib.repro_trimmed_mean(
            arena.data_ptr(), code, arena.stride(0), m.data_ptr(), out.data_ptr(),
            n, p, int(trim_k), stream,
        )
    if rc != 0:
        raise RuntimeError(f"repro_trimmed_mean launch failed with cudaError {rc}")
    count_launch(masked_trimmed_mean_cuda)
    return out


masked_trimmed_mean_cuda.launches = 0
