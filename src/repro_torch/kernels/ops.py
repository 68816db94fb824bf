"""Kernel dispatch: the hand-written kernel on the card, plain torch on the host.

The port of ``repro/kernels/ops.py`` for the ported kernels.  The device of
the input decides, and nothing else:

* a CUDA tensor goes to the Hopper kernel — a failed build or launch raises;
  there is no fallback to the plain version or to the CPU;
* a CPU tensor goes to the plain PyTorch version (the parity tests' path);
* any other device raises.

The arena reductions take an optional ``out``: the ``(P,)`` f32 tensor to
write (a window of a larger row), which the kernel writes in place.

The ``*_sharded`` builders are the reference's column-sharded reductions
(``ops.masked_fedavg_sharded`` and the rest): each returns a function that
calls the wrapper above once per slot of the mesh, on that slot's shard and
its own copy of the ``(n_max,)`` weights and mask, and writes each slot's
result into its window of one ``(P,)`` row (:func:`per_slot`).  The
reference sizes a Pallas block for each shard (``kernels/fedavg.py``'s and
``fused_agg.py``'s ``choose_block_p_*_for_shard``) so that it divides the
shard's width; the Hopper kernels take any width, so the port has no block
to choose.

:class:`QuantCodec` is the downlink's int8 codec, built on
:func:`quantize`/:func:`dequantize`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels import fused_agg as _fused
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import robust as _robust

__all__ = ["fedavg", "masked_fedavg", "masked_fedavg_sharded",
           "masked_fedavg_q8", "masked_fedavg_q8_sharded",
           "masked_trimmed_mean", "masked_trimmed_mean_sharded",
           "quantize", "dequantize", "QuantCodec", "per_slot"]


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type != "cpu":
        raise ValueError(f"no kernel route for device {x.device}; use cuda or cpu")
    return "cpu"


def _into(out: torch.Tensor | None, result: torch.Tensor) -> torch.Tensor:
    """The plain version's ``result``, written into ``out`` when one is given."""
    return result if out is None else out.copy_(result)


def fedavg(stack: torch.Tensor, weights: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """FedAvg over a packed ``(N, P)`` stack (uniform when Σw = 0)."""
    if _route(stack) == "cuda":
        return _fedavg.fedavg_cuda(stack, weights, out=out)
    return _into(out, _fedavg.fedavg_torch(stack, weights))


def masked_fedavg(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked FedAvg over the device-resident ``(N_max, P)`` arena."""
    if _route(arena) == "cuda":
        return _fedavg.masked_fedavg_cuda(arena, weights, mask, out=out)
    return _into(out, _fedavg.masked_fedavg_torch(arena, weights, mask))


def masked_fedavg_q8(
    arena_q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
    mask: torch.Tensor, group: int = _quant.DEFAULT_GROUP,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused dequant-into-aggregate over a quantized ``(N, P)`` arena.

    ``P`` must be a whole number of groups (the scales are ``(N, P//group)``);
    no padding is needed for any such width.
    """
    if _route(arena_q) == "cuda":
        return _fused.masked_fedavg_q8_cuda(arena_q, scales, weights, mask, group, out=out)
    return _into(out, _fused.masked_fedavg_q8_torch(arena_q, scales, weights, mask, group))


def masked_trimmed_mean(
    arena: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor, trim_k: int = 1,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked trimmed mean over the device-resident ``(N_max, P)`` arena, f32.

    Signature-compatible with ``core/aggregation.masked_trimmed_mean``:
    ``weights`` is accepted and ignored, order statistics being weight-blind.
    Any width runs unpadded; float rows other than f32 and bf16 are read as f32.
    """
    del weights  # order statistics are weight-blind by design
    if arena.dtype not in (torch.float32, torch.bfloat16):
        arena = arena.to(torch.float32)
    if _route(arena) == "cuda":
        return _robust.masked_trimmed_mean_cuda(arena, mask, trim_k, out=out)
    return _into(out, _robust.masked_trimmed_mean_torch(arena, mask, trim_k))


# ---------------------------------------------------------------------------
# Column-sharded reductions: one wrapper call a slot
# ---------------------------------------------------------------------------


def per_slot(reduce, mesh, axes=None, n_parts: int = 1):
    """A column-sharded reduction built from a one-device ``reduce``.

    Returns ``fn(*parts, *vectors) -> (P,)``: the first ``n_parts`` arguments
    are column-sharded arrays (a ``models.sharding.ColumnShards`` as the
    sharded arena holds them, or whole tensors, laid out first), the rest are
    ``(n_max,)`` vectors, copied once to each slot's device.  ``reduce(*slot
    parts, *slot vectors, out=window)`` runs once a slot, on that slot's
    device, and writes its window of the f32 result directly where the
    window lies on the same device and starts 16-byte aligned, else through
    one copy.  The result is assembled on the mesh's first slot device.  No
    data crosses slots inside the reduce: every rule it serves is per column.
    """
    from repro_torch.models.sharding import arena_specs

    layout, _, repl = arena_specs(mesh, axes)
    home = layout.devices[0]

    def fn(*args):
        parts = [layout.split(a) for a in args[:n_parts]]
        vectors = [repl.put(v) for v in args[n_parts:]]
        widths = [int(s.shape[-1]) for s in parts[0]]
        out = torch.empty((sum(widths),), dtype=torch.float32, device=home)
        start = 0
        for s, width in enumerate(widths):
            window = out[start: start + width]
            start += width
            shard = [p[s] for p in parts]
            direct = shard[0].device == home and window.data_ptr() % 16 == 0
            got = reduce(*shard, *(v[s] for v in vectors), out=window if direct else None)
            if got is not window:
                window.copy_(got)
        return out

    return fn


def masked_fedavg_sharded(mesh, axes=None):
    """Kernel-backed masked FedAvg over a column-sharded arena.

    Returns ``(arena (N_max, P), weights, mask) -> (P,)``: kernel 1 once per
    slot, on the slot's ``(N_max, P/n_shards)`` shard (:func:`per_slot`).
    """
    return per_slot(masked_fedavg, mesh, axes)


def masked_fedavg_q8_sharded(mesh, axes=None, group: int = _quant.DEFAULT_GROUP):
    """Fused dequant-into-aggregate over a column-sharded quantized arena.

    Returns ``(arena_q (N, P) int8, scales (N, P//group), weights, mask) ->
    (P,)``: values and scales share the column layout
    (``ArenaStore(arena_dtype="int8", mesh=...)`` keeps every shard a whole
    number of groups), and kernel 5 runs once per slot.
    """

    def _local(q, scales, weights, mask, out=None):
        if q.shape[-1] != scales.shape[-1] * group:
            raise ValueError(
                f"a shard of {q.shape[-1]} int8 values holds {scales.shape[-1]} scales "
                f"of group {group}; shards must be whole groups"
            )
        return masked_fedavg_q8(q, scales, weights, mask, group, out=out)

    return per_slot(_local, mesh, axes, n_parts=2)


def masked_trimmed_mean_sharded(mesh, axes=None, trim_k: int = 1):
    """Kernel-backed masked trimmed mean over a column-sharded arena.

    Returns ``(arena (N_max, P), weights, mask) -> (P,)``: the rule is
    coordinate-wise, so kernel 6 rank-selects once per slot within the slot's
    own ``(N_max, P/n_shards)`` shard.
    """

    def _local(arena, weights, mask, out=None):
        return masked_trimmed_mean(arena, weights, mask, trim_k, out=out)

    return per_slot(_local, mesh, axes)


def quantize(
    x: torch.Tensor, group: int = _quant.DEFAULT_GROUP,
    block_rows: int = _quant.DEFAULT_BLOCK_ROWS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(P,)`` -> ``(q int8, scales f32)``, zero-padded to a ``group * block_rows``
    multiple as the reference's kernel requires; the caller keeps ``P``.

    The row is read unpadded: the kernel (or the plain version) reads the pad
    as zeros and writes ``q`` and every group's scale into one buffer in the
    int8 wire's layout, whose views they are (``quantize.wire_prefix``).
    """
    if x.ndim != 1 or x.dtype != torch.float32:
        x = x.reshape(-1).to(torch.float32)
    tile = group * block_rows
    n_padded = -(-x.shape[0] // tile) * tile
    if _route(x) == "cuda":
        return _quant.quantize_cuda(x, group, n_padded)
    return _quant.quantize_torch(x, group, n_padded)


def dequantize(
    q: torch.Tensor, scales: torch.Tensor, orig_size: int,
    group: int = _quant.DEFAULT_GROUP, block_rows: int = _quant.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """Inverse of :func:`quantize`, sliced back to ``orig_size`` elements."""
    rows = q.shape[0] // group
    if q.shape[0] % group or rows % block_rows:
        raise ValueError(
            f"dequantize needs q.shape[0]={q.shape[0]} divisible by "
            f"group*block_rows={group}*{block_rows}={group * block_rows} "
            "(quantize emits that layout)"
        )
    if scales.shape[0] != rows:
        raise ValueError(
            f"dequantize got {scales.shape[0]} scales for {rows} groups of {group}; "
            "re-pad trimmed wire scales first (kernels.quantize.scales_padding)"
        )
    if _route(q) == "cuda":
        x = _quant.dequantize_cuda(q, scales, group)
    else:
        x = _quant.dequantize_torch(q, scales, group)
    return x[:orig_size]


_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float64": 3}
_DTYPE_NAMES = {v: getattr(torch, k) for k, v in _DTYPE_CODES.items()}


def _is_quant(node: Any) -> bool:
    return isinstance(node, dict) and "__quant__" in node


def _map(fn, node: Any) -> Any:
    """Apply ``fn`` to every leaf, treating an encoded-leaf dict as one leaf."""
    if isinstance(node, dict) and not _is_quant(node):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v) for v in node)
    return fn(node)


class QuantCodec:
    """Transport codec for ``core/transport.Channel``: tree -> int8 + scales.

    Encodes every float leaf; integer leaves pass through.  Stateless: size,
    dtype and shape ride along in the encoded leaf's ``__quant__`` vector, so
    any receiver can decode (lossy to the int8 step).  That vector is int32,
    as the reference's is (its ``jnp.int64`` request becomes int32 without
    JAX's x64 mode), so the downlink's bytes equal the reference's.
    """

    @staticmethod
    def encode(params: Any) -> Any:
        """Quantize every float leaf to int8 + scales (ints pass through)."""

        def enc(leaf):
            leaf = torch.as_tensor(leaf)
            if not leaf.is_floating_point():
                return leaf
            flat = leaf.to(torch.float32).reshape(-1)
            q, s = quantize(flat)
            meta = [flat.shape[0], _DTYPE_CODES[str(leaf.dtype).removeprefix("torch.")]]
            return {
                "__quant__": torch.tensor(meta + list(leaf.shape), dtype=torch.int32,
                                          device=leaf.device),
                "q": q,
                "s": s,
            }

        return _map(enc, params)

    @staticmethod
    def decode(encoded: Any) -> Any:
        """Reconstruct the tree encoded by :meth:`encode` (lossy to int8)."""

        def dec(leaf):
            if not _is_quant(leaf):
                return leaf
            meta = [int(v) for v in leaf["__quant__"].tolist()]
            size, dtc, shape = meta[0], meta[1], tuple(meta[2:])
            x = dequantize(leaf["q"], leaf["s"], size)
            return x.reshape(shape).to(_DTYPE_NAMES[dtc])

        return _map(dec, encoded)
