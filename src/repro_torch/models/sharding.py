"""How the sharded aggregation arena lies on the controller's slot mesh.

The port of ``repro/models/sharding.py::arena_specs``.  The reference
returns ``NamedSharding``s and lets XLA place each shard; torch has no such
layout type, so the port's layouts are small objects that do the placing
themselves:

* :class:`Columns` — ``P(None, axes)`` for the ``(n_max, P)`` arena and
  ``P(axes)`` for one ``(P,)`` row: the last dimension cut into one window a
  slot, slot ``s`` (row-major over ``axes``) owning window ``s``;
* :class:`Replicated` — ``P()`` for the ``(n_max,)`` metadata vectors: one
  copy on every slot's device;
* :class:`ColumnShards` — what a :class:`Columns` layout holds: one tensor
  a slot, each its own allocation on its slot's device, in slot order.

An axis of ``width`` columns over ``n`` slots is cut into ``n`` windows of
``width / n``; a width that ``n`` does not divide raises ``ValueError``, as
the reference's column shardings refuse it.  The arena pads its rows so that
``n`` divides them.

``ShardingPolicy``, ``make_policy``, ``constrain`` and ``seq_constrain`` (the
model axis) are not ported yet: they are slice G-2 of the port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.launch.mesh import SlotMesh

__all__ = ["arena_specs", "Columns", "Replicated", "ColumnShards"]


class ColumnShards(tuple):
    """An array held as column shards, one tensor a slot, in slot order.

    Reads like the array it holds where the arena needs it to: ``shape``,
    ``dtype`` and ``nbytes`` are the whole array's; :meth:`assemble` gathers
    it onto one device.
    """

    @property
    def shape(self) -> tuple[int, ...]:
        first = self[0]
        return tuple(first.shape[:-1]) + (sum(int(s.shape[-1]) for s in self),)

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(int(s.nbytes) for s in self)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(s.device for s in self)

    def assemble(self, device: torch.device | str) -> torch.Tensor:
        """The whole array on ``device``: the shards side by side."""
        return torch.cat([s.to(device) for s in self], dim=-1)


def windows(width: int, n: int) -> list[tuple[int, int]]:
    """Slot ``s``'s columns ``[start, stop)`` of an axis of ``width`` over ``n`` slots."""
    if width % n:
        raise ValueError(f"an axis of {width} columns does not divide over {n} slots")
    w = width // n
    return [(s * w, (s + 1) * w) for s in range(n)]


@dataclasses.dataclass(frozen=True, eq=False)
class Columns:
    """The last dimension of an array split over ``axes``' slots."""

    mesh: SlotMesh
    axes: tuple[str, ...]

    @functools.cached_property
    def devices(self) -> tuple[torch.device, ...]:
        """Each slot's device, in slot order (row-major over :attr:`axes`)."""
        return self.mesh.slot_devices(self.axes)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def windows(self, width: int) -> list[tuple[int, int]]:
        """Each slot's column window of an axis of ``width``."""
        return windows(width, self.n_shards)

    def split(self, x: torch.Tensor) -> ColumnShards:
        """``x`` laid out: each slot's window of its last dimension copied onto
        the slot's device.

        A :class:`ColumnShards` already laid out over as many slots comes
        back as it is.
        """
        if isinstance(x, ColumnShards):
            if len(x) != self.n_shards:
                raise ValueError(f"{len(x)} shards for a layout of {self.n_shards} slots")
            return x
        return ColumnShards(
            x[..., a:b].to(dev, copy=True).contiguous()
            for dev, (a, b) in zip(self.devices, self.windows(x.shape[-1]))
        )

    def zeros(self, shape: Sequence[int], dtype: torch.dtype) -> ColumnShards:
        """Zeros of ``shape`` laid out, each shard allocated on its slot's device."""
        *lead, width = shape
        return ColumnShards(
            torch.zeros((*lead, b - a), dtype=dtype, device=dev)
            for dev, (a, b) in zip(self.devices, self.windows(width))
        )


@dataclasses.dataclass(frozen=True, eq=False)
class Replicated:
    """A small array whole on every slot: one copy a distinct device."""

    mesh: SlotMesh
    axes: tuple[str, ...]

    @functools.cached_property
    def devices(self) -> tuple[torch.device, ...]:
        return self.mesh.slot_devices(self.axes)

    def put(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``x`` on each slot's device, in slot order (one transfer a device;
        none where ``x`` is there already)."""
        x = torch.as_tensor(x)
        copies: dict[torch.device, torch.Tensor] = {}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = x.to(dev)
        return tuple(copies[dev] for dev in self.devices)


def arena_specs(
    mesh: SlotMesh, axes: str | tuple[str, ...] | None = None
) -> tuple[Columns, Columns, Replicated]:
    """Layouts for a column-sharded aggregation arena on ``mesh``.

    Returns ``(buffer_layout, row_layout, replicated)``: the ``(n_max, P)``
    arena split along ``P`` over ``axes`` (default: the mesh's ``"data"``
    axis if it has one, else every axis), a ``(P,)`` row split the same way,
    and the ``(n_max,)`` metadata vectors whole on every slot.
    """
    from repro_torch.core.aggregation import arena_axes

    axes = arena_axes(mesh, axes)
    return Columns(mesh, axes), Columns(mesh, axes), Replicated(mesh, axes)
