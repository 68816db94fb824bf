"""Blockwise int8 quantize/dequantize: the wire layout and the kernels' wrappers.

Replaces the reference's TPU kernels ``repro/kernels/quantize.py``
``quantize_pallas`` (every int8 upload's encode, and ``ArenaStore.write`` on
an int8 arena) and ``dequantize_pallas`` (the controller's int8 decode onto
an f32 row).  The packed ``(P,)`` buffer is viewed as ``(P/group, group)``
rows; each group gets a symmetric scale ``max|x|/127``.  The CUDA kernels are
in ``csrc/quantize.cu``; its header gives the bound and the design.

Quantize reads an unpadded ``(n,)`` row as zero-padded to ``P`` and writes
``q`` and every group's scale into one buffer laid out as the int8 wire (the
``P`` int8 values, then the ``P/group`` f32 scales); ``q`` and the scales
are views of it, and :func:`wire_prefix` is the wire an upload sends.

The host layout helpers (:func:`effective_block_rows`, :func:`wire_layout`,
:func:`scales_padding`) are the reference's word for word: they fix the
wire bytes, so both packages emit identical int8 envelopes.

Beside each kernel wrapper sits its plain PyTorch version: the CPU tests run
it, and ``chip_smoke.py`` holds the kernel against it on the card.  Both
follow the reference's executed arithmetic bit for bit:

* ``scale = amax * float32(1/127)`` (XLA folds the reference's ``amax / 127``
  into that multiply), or 1.0 when ``amax > 0`` is false (a NaN group);
* ``q = clip(round_half_even(x / scale), -127, 127)`` with IEEE division, and
  a NaN quotient (a NaN element, ``inf/inf``, ``0/0``) becomes 0;
* subnormal floats count as zero, as the reference computes them: XLA
  flushes subnormal inputs and results to zero on the CPU, and the TPU has
  none.  An element below ``FLT_MIN`` in magnitude reads as 0, and a scale
  that would be subnormal is 0.

Each kernel wrapper counts its launches in a plain integer
(``quantize_cuda.launches``, ``dequantize_cuda.launches``), incremented only
where the kernel is launched.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import count_launch, load_library
__all__ = [
    "DEFAULT_GROUP", "DEFAULT_BLOCK_ROWS", "effective_block_rows", "wire_layout",
    "scales_padding", "wire_prefix", "quantize_torch", "dequantize_torch", "quantize_cuda",
    "dequantize_cuda",
]

DEFAULT_GROUP = 256
DEFAULT_BLOCK_ROWS = 64

#: ``float32(1/127)``: the reference's scale multiplier.
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
#: The smallest normal float32; anything smaller in magnitude counts as zero.
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def effective_block_rows(
    n: int, group: int = DEFAULT_GROUP, block_rows: int = DEFAULT_BLOCK_ROWS
) -> int:
    """Block height actually used for an ``(n,)`` buffer (the reference's rule).

    ``block_rows`` is a cap: a buffer under one ``group * block_rows`` tile
    shrinks the block to its own row count; a larger one gets the tallest
    block whose row padding stays within ~6.25% of the needed rows.  Both
    codec halves derive it from ``n`` alone.
    """
    rows_needed = max(1, (n + group - 1) // group)
    if rows_needed <= block_rows:
        return rows_needed
    budget = -(-rows_needed // 16)  # allow <= ~6.25% padded rows
    for rows in range(block_rows, 0, -1):
        if (-rows_needed) % rows <= budget:
            return rows
    return 1  # unreachable: rows=1 always pads zero rows


def wire_layout(
    n: int, group: int = DEFAULT_GROUP, block_rows: int = DEFAULT_BLOCK_ROWS
) -> tuple[int, int, int]:
    """Wire layout of one quantized ``(n,)`` buffer.

    Returns ``(n_padded, n_scales, payload_bytes)``: the tile-padded element
    count, the number of f32 group scales shipped (``ceil(n / group)``: only
    groups holding real data), and the payload bytes (``n_padded`` int8
    values followed by ``n_scales`` f32 scales).
    """
    tile = group * effective_block_rows(n, group, block_rows)
    n_padded = ((n + tile - 1) // tile) * tile
    n_scales = (n + group - 1) // group
    return n_padded, n_scales, n_padded + 4 * n_scales


def scales_padding(
    n: int, group: int = DEFAULT_GROUP, block_rows: int = DEFAULT_BLOCK_ROWS
) -> int:
    """How many trailing pad-group scales (each 1.0) the decoder re-synthesizes."""
    n_padded, n_scales, _ = wire_layout(n, group, block_rows)
    return n_padded // group - n_scales


def _check_groups(n: int, group: int, what: str) -> int:
    if group < 8 or group % 8:
        raise ValueError(f"the quant group must be a positive multiple of 8, got {group}")
    if n % group:
        raise ValueError(f"{what} holds {n} elements, not a multiple of group={group}")
    return n // group


def _padded_groups(n: int, n_padded: int | None, group: int) -> tuple[int, int]:
    """``(n_padded, groups)`` of a row of ``n`` elements read as zero-padded to
    ``n_padded`` (``n`` when ``None``), a whole number of groups."""
    if n_padded is None:
        n_padded = n
    elif n_padded < n:
        raise ValueError(f"cannot pad {n} elements to {n_padded}")
    return n_padded, _check_groups(n_padded, group, "x")


def _wire_buffer(
    like: torch.Tensor, n_padded: int, groups: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scales)``: views of one new buffer on ``like``'s device laid out
    as the int8 wire, ``n_padded`` int8 values then ``groups`` f32 scales
    (``n_padded`` is a whole number of groups, so a multiple of 4)."""
    q, scales = like.new_empty((n_padded // 4 + groups,), dtype=torch.float32).split_with_sizes(
        [n_padded // 4, groups])
    return q.view(torch.int8), scales


def wire_prefix(q: torch.Tensor, scales: torch.Tensor, n_scales: int) -> torch.Tensor:
    """The int8 wire of a quantized row, without a copy: ``q``'s bytes then
    its first ``n_scales`` scales, as a uint8 view of the one buffer that
    :func:`quantize_torch` and :func:`quantize_cuda` write."""
    one_buffer = (q.untyped_storage().data_ptr() == scales.untyped_storage().data_ptr()
                  and scales.data_ptr() == q.data_ptr() + q.shape[0])
    if not one_buffer or not 0 <= n_scales <= scales.shape[0]:
        raise ValueError("q and its scales are not one wire buffer")
    return q.view(torch.uint8).as_strided((q.shape[0] + 4 * n_scales,), (1,))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card yardstick)
# ---------------------------------------------------------------------------


def quantize_torch(
    x: torch.Tensor, group: int = DEFAULT_GROUP, n_padded: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(n,)`` f32 -> ``(q int8 (P,), scales f32 (P/group,))``, plain torch.

    ``x`` is read as zero-padded to ``P = n_padded`` (``n`` when ``None``);
    ``q`` and ``scales`` are views of one buffer in the wire's layout
    (:func:`wire_prefix`).
    """
    n_padded, rows = _padded_groups(x.shape[0], n_padded, group)
    xg = torch.nn.functional.pad(x.to(torch.float32), (0, n_padded - x.shape[0]))
    xg = xg.reshape(rows, group)
    xg = torch.where(xg.abs() < FLT_MIN, 0.0, xg)
    amax = xg.abs().amax(dim=1, keepdim=True)
    scale = amax * INV_127.to(x.device)
    scale = torch.where(scale < FLT_MIN, 0.0, scale)
    scale = torch.where(amax > 0, scale, 1.0)
    q = torch.round(xg / scale)
    q = torch.where(torch.isnan(q), 0.0, q.clamp(-127.0, 127.0))
    q_out, s_out = _wire_buffer(x, n_padded, rows)
    q_out.copy_(q.to(torch.int8).reshape(-1))
    s_out.copy_(scale[:, 0])
    return q_out, s_out


def dequantize_torch(
    q: torch.Tensor, scales: torch.Tensor, group: int = DEFAULT_GROUP
) -> torch.Tensor:
    """Inverse of :func:`quantize_torch`: ``q * scale[group]`` in f32, plain torch."""
    rows = _check_groups(q.shape[0], group, "q")
    x = q.to(torch.float32).reshape(rows, group) * scales.to(torch.float32)[:, None]
    return x.reshape(-1)


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor, what: str, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous 1-D CUDA tensor of ``dtype`` on a 16-byte boundary."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor for {what}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {tuple(t.shape)}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry, t: torch.Tensor, *args) -> int:
    """``entry(*args, stream)`` on the current stream of ``t``'s device;
    returns its rc.

    A 10 MB row's kernel takes about 20 us on the card, so the host's share
    of each call counts: the device's context is entered only when it is not
    the current device, and the stream is read as its raw handle, not as a
    ``Stream`` object."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))


def quantize_cuda(
    x: torch.Tensor, group: int = DEFAULT_GROUP, n_padded: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantization on the card through the hand-written kernel.

    ``x`` is an ``(n,)`` f32 CUDA tensor, read as zero-padded to
    ``P = n_padded`` (``n`` when ``None``), a whole number of groups.  One
    launch writes ``q`` and every group's scale into one buffer in the wire's
    layout; they come back as views of it (:func:`wire_prefix`).  Raises on
    anything else or a failed launch.
    """
    x = _aligned(x, "x", torch.float32)
    n = x.shape[0]
    n_padded, rows = _padded_groups(n, n_padded, group)
    q, scales = _wire_buffer(x, n_padded, rows)
    rc = _launch(load_library().lib.repro_quantize, x, x.data_ptr(), n, q.data_ptr(),
                 scales.data_ptr(), rows, group)
    if rc != 0:
        raise RuntimeError(f"repro_quantize launch failed with cudaError {rc}")
    count_launch(quantize_cuda)
    return q, scales


def dequantize_cuda(
    q: torch.Tensor, scales: torch.Tensor, group: int = DEFAULT_GROUP
) -> torch.Tensor:
    """``q * scale[group]`` on the card through the hand-written kernel."""
    q = _aligned(q, "q", torch.int8)
    scales = _aligned(scales, "scales", torch.float32)
    n = q.shape[0]
    rows = _check_groups(n, group, "q")
    if scales.shape[0] != rows or scales.get_device() != q.get_device():
        raise ValueError(
            f"got {scales.shape[0]} scales on {scales.device} for {rows} groups of "
            f"{group} on {q.device}"
        )
    out = q.new_empty((n,), dtype=torch.float32)
    rc = _launch(load_library().lib.repro_dequantize, q, q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), n, group)
    if rc != 0:
        raise RuntimeError(f"repro_dequantize launch failed with cudaError {rc}")
    count_launch(dequantize_cuda)
    return out


quantize_cuda.launches = 0
dequantize_cuda.launches = 0
