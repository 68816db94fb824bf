"""Masked secure aggregation with exact cancellation.

The port of ``repro/core/secure.py``: LightSecAgg-style pairwise masking, the
*masking* family the paper's Table 1 attributes to Flower/FedML (MetisFL's
own CKKS encryption has no counterpart here).  Every ordered pair of learners
``(i, j)`` derives a shared one-time pad from a pairwise seed; learner ``i``
adds ``+m_ij`` and learner ``j`` adds ``-m_ij`` to its upload.  The
controller's sum of all masked uploads equals the sum of the true uploads
**exactly**, while any single upload is masked by a pad uniform over
``Z_2^32``.

Exactness needs the integers: learners encode their already FedAvg-weighted
buffers in int32 fixed point, mask with wrapping int32 addition, and the
controller sums and decodes.  The only error is the fixed-point rounding,
at most ``N / (2 * scale)`` per coordinate.

What differs from the reference, and what does not:

* the pads come from ``torch.Generator`` (Philox on the card, mt19937 on the
  host), not threefry, so a masked upload differs from the reference's; the
  pads cancel, so :func:`encode_fixed`, the unmasked sum and the aggregate
  are the reference's bit for bit;
* a pad is drawn as int64 in ``[0, 2^32)`` and wrapped to int32, so its sign
  bit is as random as its other bits (an int32 ``random_()`` never sets it);
* the wrapping sum is kept as residues mod 2^32 in int64 tensors, defined
  the same way on the host and the card, and wrapped to int32 once;
* :func:`encode_fixed` reproduces XLA's float-to-int32 convert explicitly:
  NaN encodes as 0 and out-of-range values saturate to the int32 limits
  (torch's own cast is undefined there and differs between host and card).

Dropout recovery (SecAgg+ secret-sharing of seeds) is out of scope: every
selected participant must survive to unmasking, as in the paper's
synchronous stress tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "PairwiseMasker",
    "MaskSession",
    "encode_fixed",
    "decode_fixed",
    "mask_upload",
    "secure_fedavg",
    "secure_fedavg_arena",
    "FIXED_SCALE",
]

FIXED_SCALE = float(1 << 16)
_MOD = 1 << 32
_LOW32 = _MOD - 1
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class MaskSession:
    """One secure-aggregation epoch: the session every mask seed derives from.

    Keyed by ``(base_seed, epoch)``, where ``epoch`` is the synchronous round
    id or, on the continuous (async) path, the global model version the
    community update commits: every epoch gets fresh one-time pads, so an
    upload masked in one session can never be unmasked against pads from
    another.
    """

    base_seed: int
    epoch: int

    @property
    def seed(self) -> int:
        """The session's 31-bit mask seed (an integer hash of the key pair)."""
        mixed = (
            (self.base_seed * 2654435761)
            ^ (self.epoch * 2246822519)
            ^ 0x9E3779B9
        )
        return mixed % (1 << 31)

    def masker(self, n_participants: int) -> PairwiseMasker:
        """The session's pairwise mask generator over ``n_participants``."""
        return PairwiseMasker(
            base_seed=self.seed, participants=tuple(range(n_participants))
        )


def _pair_seed(base_seed: int, i: int, j: int) -> int:
    """Order-independent pairwise seed (canonicalized to i < j)."""
    a, b = (i, j) if i < j else (j, i)
    mod = 1 << 32
    return ((base_seed * 2654435761) % mod) ^ ((a * 40503) % mod) ^ ((b * 9973) % mod)


def _mask(seed: int, size: int, device: torch.device) -> torch.Tensor:
    """A pad of ``size`` values uniform over ``[0, 2^32)``, as int64 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, _MOD, (size,), generator=gen, device=device, dtype=torch.int64)


def _to_int32(residues: torch.Tensor) -> torch.Tensor:
    """int64 residues in ``[0, 2^32)`` as the int32 values they wrap to."""
    return torch.where(residues > _INT32_MAX, residues - _MOD, residues).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PairwiseMasker:
    """Mask generator for one secure-aggregation session."""

    base_seed: int
    participants: tuple[int, ...]

    def _net_residues(self, idx: int, size: int, device: torch.device) -> torch.Tensor:
        total = torch.zeros((size,), dtype=torch.int64, device=device)
        for other in self.participants:
            if other == idx:
                continue
            m = _mask(_pair_seed(self.base_seed, idx, other), size, device)
            if idx < other:
                total.add_(m)
            else:
                total.sub_(m)
            total.bitwise_and_(_LOW32)  # wrapping adds on Z_2^32
        return total

    def net_mask(self, idx: int, size: int,
                 device: str | torch.device | None = None) -> torch.Tensor:
        """Sum of signed pairwise pads learner ``idx`` applies to its upload
        (int32, wrapped), drawn on ``device`` (the card unless told otherwise)."""
        return _to_int32(self._net_residues(idx, size, resolve_device(device)))


def encode_fixed(buffer: torch.Tensor, scale: float = FIXED_SCALE) -> torch.Tensor:
    """float32 -> int32 fixed point: ``round(x * scale)``, halves to even.

    As XLA's convert on the host: NaN gives 0, values at or past ±2^31
    saturate to the int32 limits.
    """
    y = torch.round(buffer.to(torch.float32) * scale)
    hi = y >= 2.0 ** 31
    lo = y < -(2.0 ** 31)
    out = torch.where(hi | lo | torch.isnan(y), 0.0, y).to(torch.int32)
    out = torch.where(hi, _INT32_MAX, out)
    return torch.where(lo, _INT32_MIN, out)


def decode_fixed(ints: torch.Tensor, scale: float = FIXED_SCALE) -> torch.Tensor:
    """int32 fixed point -> float32."""
    return ints.to(torch.float32) / scale


def _masked_residues(masker: PairwiseMasker, idx: int, weighted_buffer: torch.Tensor,
                     scale: float) -> torch.Tensor:
    enc = encode_fixed(weighted_buffer, scale).to(torch.int64).bitwise_and_(_LOW32)
    net = masker._net_residues(idx, weighted_buffer.shape[0], weighted_buffer.device)
    return enc.add_(net).bitwise_and_(_LOW32)


def mask_upload(
    masker: PairwiseMasker, idx: int, weighted_buffer: torch.Tensor,
    scale: float = FIXED_SCALE,
) -> torch.Tensor:
    """Learner side: fixed-point encode + apply the net pad.  The upload is a
    uniformly masked int32 row; the controller learns nothing about a single
    model from it."""
    return _to_int32(_masked_residues(masker, idx, weighted_buffer, scale))


def _f32_weight(w: float, wsum: float) -> float:
    """``w / wsum`` in float64, rounded to float32 (the reference's
    ``jnp.float32(w / wsum)``)."""
    return float(np.float32(w / wsum))


def _masked_sum(rows: Sequence[torch.Tensor], weights: Sequence[float], base_seed: int,
                scale: float) -> torch.Tensor:
    n = len(rows)
    masker = PairwiseMasker(base_seed=base_seed, participants=tuple(range(n)))
    wsum = float(sum(weights))
    if wsum <= 0:
        raise ValueError("weights must sum to a positive value")
    total = torch.zeros((rows[0].shape[0],), dtype=torch.int64, device=rows[0].device)
    for i, (buf, w) in enumerate(zip(rows, weights)):
        total.add_(_masked_residues(masker, i, buf * _f32_weight(float(w), wsum), scale))
        total.bitwise_and_(_LOW32)
    return decode_fixed(_to_int32(total), scale)


def secure_fedavg(
    buffers: Sequence[torch.Tensor],
    weights: Sequence[float],
    base_seed: int = 0,
    scale: float = FIXED_SCALE,
) -> torch.Tensor:
    """End-to-end secure FedAvg: weight → encode → mask → sum → decode.

    FedAvg weights are folded in learner side (each learner uploads
    ``(w_i / Σw) * x_i`` in fixed point), so the controller only ever sums
    masked integers.  Returns the weighted average as float32 on the
    buffers' device, exact up to fixed-point rounding.
    """
    return _masked_sum(list(buffers), weights, base_seed, scale)


def _slot_seed(base_seed: int, slot: int) -> int:
    """The pad seed of one column slot of a sharded sum (a 31-bit integer hash)."""
    return ((base_seed * 2654435761) ^ ((slot + 1) * 2246822519) ^ 0x7F4A7C15) % (1 << 31)


def secure_fedavg_arena(
    arena: torch.Tensor,
    rows: Sequence[int],
    weights: Sequence[float],
    num_params: int | None = None,
    base_seed: int = 0,
    scale: float = FIXED_SCALE,
    out_sharding: Any = None,
) -> torch.Tensor:
    """Secure FedAvg over selected rows of a device-resident arena.

    Participants are the given ``rows`` of the persistent ``(n_max, P)``
    tensor (``core/store.ArenaStore``), sliced on the device.  Mask seeds
    derive from the *position* in ``rows`` (the session's participant
    index), so the result is bit-identical to :func:`secure_fedavg` on the
    same buffers in the same order with the same ``base_seed``.

    The sharded arena: ``arena`` is its ``ColumnShards``, or a whole tensor
    with ``out_sharding`` the row layout to sum it in
    (``models.sharding.arena_specs``; ignored, as the reference ignores it,
    when the slots do not divide ``num_params``).  The wrapping int32
    accumulator is kept per slot, over the slot's columns below
    ``num_params``, with the slot's own pairwise pads, and the decoded
    windows are assembled on the first slot's device.  The pads cancel
    exactly whatever they are, so the result is bit-identical to the
    one-device sum.
    """
    from repro_torch.models.sharding import Columns, ColumnShards

    n = len(rows)
    if n == 0:
        raise ValueError("secure aggregation needs at least one participant row")
    if n != len(weights):
        raise ValueError("rows and weights must have equal length")
    if out_sharding is not None and not isinstance(out_sharding, Columns):
        raise TypeError(
            "out_sharding must be the arena's row layout (models.sharding.arena_specs), "
            f"got {type(out_sharding).__name__}"
        )
    p = int(num_params) if num_params is not None else int(arena.shape[1])
    if not isinstance(arena, ColumnShards):
        if out_sharding is None or p % out_sharding.n_shards:
            return _masked_sum([arena[int(r), :p] for r in rows], weights, base_seed, scale)
        arena = out_sharding.split(arena[:, :p])
    out = torch.empty((p,), dtype=torch.float32, device=arena[0].device)
    start = 0
    for slot, shard in enumerate(arena):
        a, b = start, min(start + int(shard.shape[1]), p)
        start += int(shard.shape[1])
        if b > a:
            part = _masked_sum([shard[int(r), : b - a] for r in rows], weights,
                               _slot_seed(base_seed, slot), scale)
            out[a:b].copy_(part)
    return out
