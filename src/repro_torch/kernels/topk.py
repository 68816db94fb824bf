"""Top-k magnitude sparsification for the sparse uplink (error feedback).

The port of ``repro/kernels/topk.py``.  The learner accumulates its full
update into an f32 residual, ships only the ``k`` largest-magnitude
coordinates as ``(indices:int32, values)`` pairs and subtracts what it sent,
so unsent mass is carried, not lost.

The reference selects with ``jax.lax.top_k`` on ``|x|``, which is XLA's sort,
not a Pallas kernel, so the port selects with ``torch.sort``: no hand kernel
is owed.  The order is the wire's, so it must be the reference's: ``lax.top_k``
ranks by the IEEE total order of ``|x|`` (every NaN above ``inf``, NaNs by
payload) and breaks ties toward the lowest index.  ``torch.topk`` orders ties
as it likes, and a float ``torch.sort`` takes every NaN as equal on the host
but orders NaN payloads on the card; so the key is the bits of ``|x|`` as an
int32 (a non-negative float's bits order as its total order) under a stable
descending sort, the same on both devices.

Values ship as f32 (8 bytes a coordinate with the int32 index) or as int8
with one f32 scale per group of values (~5 bytes), the symmetric ``amax/127``
scheme of ``kernels/quantize.py`` over the sent values.  Every function here
is plain torch on either device, bit-identical to the reference on the host.
"""

from __future__ import annotations

import torch

__all__ = [
    "topk_select", "densify", "ef_residual",
    "quantize_values", "dequantize_values",
    "effective_k", "wire_layout_topk", "flush_subnormal",
    "DEFAULT_VALUE_GROUP", "VALUE_DTYPES",
]

DEFAULT_VALUE_GROUP = 64
VALUE_DTYPES = ("f32", "int8")

#: ``float32(1/127)``: XLA folds the reference's ``amax / 127`` into this multiply.
_INV_127 = 1.0 / 127.0
#: The smallest normal float32: XLA flushes anything smaller to zero on the host.
_FLT_MIN = float(torch.finfo(torch.float32).tiny)


def effective_k(n: int, k: int) -> int:
    """The per-buffer k actually sent: ``k`` clamped to ``[1, n]``.

    Derived from ``n`` alone on both codec halves, so the envelope's
    ``codec_params`` stay constant across uploads.
    """
    return max(1, min(int(k), int(n)))


def wire_layout_topk(
    n: int, k: int, value_dtype: str = "f32", group: int = DEFAULT_VALUE_GROUP,
) -> tuple[int, int, int]:
    """Wire layout of one sparse ``(n,)`` upload.

    Returns ``(k_eff, n_scales, payload_bytes)``: the clamped coordinate
    count, the number of f32 value-group scales shipped (0 for f32 values),
    and the payload bytes — ``4*k_eff`` int32 indices followed by either
    ``4*k_eff`` f32 values or ``k_eff`` int8 values plus ``4*n_scales`` scale
    bytes.
    """
    k_eff = effective_k(n, k)
    if value_dtype == "f32":
        return k_eff, 0, 8 * k_eff
    if value_dtype != "int8":
        raise ValueError(f"value_dtype must be one of {VALUE_DTYPES}, got {value_dtype!r}")
    n_scales = -(-k_eff // group)
    return k_eff, n_scales, 5 * k_eff + 4 * n_scales


def topk_select(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest-|x| coordinates of a flat f32 buffer, in ``lax.top_k``'s order.

    Returns ``(indices int32, values)`` with values carrying their sign
    (gathered from ``x``).  Magnitude descends by total order (a NaN of
    either sign first), ties go to the lowest index.
    """
    key = x.view(torch.int32) & 0x7FFFFFFF  # the bits of |x|
    order = torch.sort(key, descending=True, stable=True).indices[:k]
    return order.to(torch.int32), x[order]


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal replaced by a zero of its sign.

    XLA's host arithmetic reads subnormal inputs as zero and flushes
    subnormal results (the TPU has no subnormals), while torch keeps them on
    both devices; the port flushes explicitly where the reference's
    arithmetic would, so its results are the same bits on the card and the
    host.
    """
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def densify(indices: torch.Tensor, values: torch.Tensor, width: int) -> torch.Tensor:
    """Scatter one sparse ``(idx, val)`` stream into a dense f32 ``(width,)`` row.

    Adds into zeros, as the reference's ``.at[].add`` does, so a ``-0.0``
    value lands as ``+0.0`` and a subnormal as ``0.0``.  Indices are unique
    (top-k output), so each slot takes one add and the card's atomics
    cannot reorder anything.
    """
    out = torch.zeros((width,), dtype=torch.float32, device=values.device)
    return out.index_add_(0, indices.to(torch.int64), flush_subnormal(values.to(torch.float32)))


def ef_residual(
    acc: torch.Tensor, indices: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Error-feedback carry: ``acc`` with the sent values subtracted (a new tensor).

    With f32 values the sent coordinates zero out exactly (``x - x``); with
    int8 values the residual keeps the quantization error.  Only the ``k``
    sent coordinates are computed (subnormals flushed as the reference's
    add does); the rest is a copy.
    """
    idx = indices.to(torch.int64)
    sent = flush_subnormal(acc[idx]) + flush_subnormal(-values.to(acc.dtype))
    return acc.index_copy(0, idx, flush_subnormal(sent))


def _value_groups(values: torch.Tensor, group: int) -> torch.Tensor:
    k = values.shape[0]
    n_scales = -(-k // group)
    v = torch.nn.functional.pad(values.to(torch.float32), (0, n_scales * group - k))
    return v.reshape(n_scales, group)


def quantize_values(
    values: torch.Tensor, group: int = DEFAULT_VALUE_GROUP
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization of a dense value vector.

    Groups of ``group`` values share one f32 scale ``max|v|/127`` (1.0 where
    ``max|v| > 0`` is false, NaN included).  The reference's executed
    arithmetic, spelled out: subnormals count as zero, the scale is
    ``amax * float32(1/127)``, ``round_half_even(v / scale)`` is clipped to
    ±127, and a NaN quotient becomes 0 (XLA's int8 convert of NaN).
    Returns ``(q int8 (k,), scales f32 (ceil(k/group),))``.
    """
    k = values.shape[0]
    v = _value_groups(values, group)
    v = torch.where(v.abs() < _FLT_MIN, 0.0, v)
    amax = v.abs().amax(dim=1)
    scales = amax * torch.tensor(_INV_127, dtype=torch.float32, device=v.device)
    scales = torch.where(scales < _FLT_MIN, 0.0, scales)
    scales = torch.where(amax > 0, scales, 1.0)
    q = torch.round(v / scales[:, None]).clamp(-127.0, 127.0)
    q = torch.where(torch.isnan(q), 0.0, q).to(torch.int8)
    return q.reshape(-1)[:k], scales


def dequantize_values(
    q: torch.Tensor, scales: torch.Tensor, group: int = DEFAULT_VALUE_GROUP
) -> torch.Tensor:
    """Inverse of :func:`quantize_values`: ``q * scale`` per group, f32 ``(k,)``."""
    k = q.shape[0]
    v = _value_groups(q, group)
    return (v * scales.to(torch.float32)[:, None]).reshape(-1)[:k]
