"""Sharding on a slot mesh: the aggregation arena's layouts and the model axis.

The port of ``repro/models/sharding.py``.  For ``arena_specs`` the reference
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

The model axis: :class:`ShardingPolicy` (the reference's fields and
defaults) over a ``("data", "model")`` or ``("pod", "data", "model")``
slot mesh, and :func:`make_policy`, pure arithmetic over the config and the
mesh's shape.  PyTorch has no sharding annotation, so :func:`constrain` and
:func:`seq_constrain` return their input as it is; the reference's
``with_sharding_constraint`` changes no value either.  The reference's
``shard_map`` bodies (``models/layers.py``: the expert-parallel MoE, flash
decoding over a sequence-sharded cache, MLA's sharded decode) run in the
port once a slot, in slot order, and their collectives are these
functions, the one place each is stood in for:

* ``axis_index`` — the slot's index along the axis: the loop's index over
  :func:`slot_grid`'s rows (data) and columns (model);
* ``psum`` — :func:`psum`: each slot's partial brought to the first slot's
  device and added in slot order (in f32 where the reference casts to f32
  before its ``psum``);
* ``pmax`` — :func:`pmax`: the same with ``maximum``;
* ``pmean`` — :func:`pmean`: :func:`psum` over the count;
* ``all_gather`` over the data axes (tokens, FSDP weights) —
  :func:`all_gather`: concatenation in slot order.  Weights and caches are
  not placed per slot (``launch/specs.py`` computes their specs, as the
  reference's does, and places nothing), so a gathered weight is the whole
  tensor and a slot reads its block of it.

A slot's inputs reach its device with ``.to(dev)``, which returns the very
tensor when the slot shares that device: one card runs the multi-slot path
with no copy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import SlotMesh

__all__ = ["ShardingPolicy", "make_policy", "constrain", "seq_constrain", "arena_specs",
           "Columns", "Replicated", "ColumnShards", "slot_grid", "psum", "pmax", "pmean",
           "all_gather"]


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


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How a model lies on a slot mesh: the reference's fields and defaults.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.SlotMesh` with a
    ``model`` axis and the ``data_axes``, or ``None`` (no policy: every
    function takes its one-device path).
    """

    mesh: SlotMesh | None
    data_axes: tuple[str, ...] = ("data",)  # ("pod", "data") in multi-pod
    model_axis: str = "model"
    shard_q_heads: bool = True
    shard_kv_heads: bool = True
    shard_ssm_heads: bool = True
    fsdp_params: bool = False  # shard param d_model dim over data axes too
    # Megatron-style sequence parallelism: residual stream sharded over
    # `model` along S between blocks.
    seq_parallel: bool = True
    # serving layout: weights-stationary decode (MoE experts over model x data)
    serving: bool = False

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.mesh else 1

    def batch_spec(self, ndim: int) -> tuple:
        """Activations: batch over the data axes, the rest replicated (the
        reference's ``PartitionSpec`` entries as a tuple; one axis by its name,
        as ``PartitionSpec`` reads a one-axis tuple back)."""
        axes = self.data_axes[0] if len(self.data_axes) == 1 else self.data_axes
        return (axes, *([None] * (ndim - 1)))

    def fsdp_axes(self):
        return self.data_axes if self.fsdp_params else None


def make_policy(cfg, mesh: SlotMesh | None, multi_pod: bool = False,
                fsdp: bool | None = None, seq_parallel: bool = True,
                serving: bool = False) -> ShardingPolicy:
    """The reference's rules over ``mesh.shape``: query (KV, SSM) heads shard
    over ``model`` iff it divides them (KV heads also need at least one a
    slot); FSDP (``fsdp=None``) from ``param_count_estimate() >= 8e9``;
    ``("pod", "data")`` as the data axes when ``multi_pod``."""
    if mesh is None:
        return ShardingPolicy(mesh=None)
    msize = mesh.shape["model"]
    if fsdp is None:
        fsdp = cfg.param_count_estimate() >= 8e9
    return ShardingPolicy(
        mesh=mesh,
        data_axes=("pod", "data") if multi_pod else ("data",),
        model_axis="model",
        shard_q_heads=cfg.n_heads % msize == 0,
        shard_kv_heads=cfg.n_kv_heads % msize == 0 and cfg.n_kv_heads >= msize,
        shard_ssm_heads=(cfg.ssm_heads % msize == 0) if cfg.ssm_state else False,
        fsdp_params=bool(fsdp),
        seq_parallel=seq_parallel,
        serving=serving,
    )


def constrain(x: torch.Tensor, policy: ShardingPolicy | None, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``, which changes no value:
    PyTorch has no sharding annotation to hint, so ``x`` comes back as it is,
    with a policy or without."""
    return x


def seq_constrain(x: torch.Tensor, policy: ShardingPolicy | None) -> torch.Tensor:
    """The residual stream's constraint (batch over data, S over model at
    layer boundaries): ``x`` as it is, as :func:`constrain`."""
    return x


def slot_grid(policy: ShardingPolicy) -> np.ndarray:
    """The policy's slots as a ``(data, model)`` grid of devices: row ``d``
    is the ``d``-th slot of the data axes (row-major over them), column
    ``m`` the ``m``-th along ``model``."""
    mesh = policy.mesh
    axes = (*policy.data_axes, policy.model_axis)
    order = [mesh.axis_names.index(a) for a in axes]
    if len(order) != len(mesh.axis_names):
        raise ValueError(f"a policy over {axes} on a mesh of axes {mesh.axis_names}")
    grid = np.transpose(mesh.devices, order)
    return grid.reshape(-1, mesh.shape[policy.model_axis])


def psum(parts, device: torch.device) -> torch.Tensor:
    """``psum``: the slots' partials on ``device``, added in slot order."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def pmax(parts, device: torch.device) -> torch.Tensor:
    """``pmax``: the slots' partials on ``device``, their maximum in slot order."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = torch.maximum(out, part.to(device))
    return out


def pmean(parts, device: torch.device) -> torch.Tensor:
    """``pmean``: :func:`psum` over the number of slots."""
    return psum(parts, device) / len(parts)


def all_gather(parts, dim: int, device: torch.device) -> torch.Tensor:
    """``all_gather(..., tiled=True)``: the slots' blocks side by side along
    ``dim`` on ``device``, in slot order."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([part.to(device) for part in parts], dim=dim)
