"""Meshes of slots, each naming the device it lives on, and the card's constants.

The port of ``repro/launch/mesh.py``: the controller mesh, the debug mesh,
the production meshes and the ``HARDWARE`` constants the roofline reads
(``launch/roofline.py``), here the H100 SXM's.  The reference lays its sharded arena out over a ``jax.sharding.Mesh`` of the
controller's local devices; the port's :class:`SlotMesh` is the same grid,
with a ``torch.device`` in each cell.  A *slot* is one cell: it holds one
shard of whatever is laid out over the mesh, and slots may share a device.
With as many devices as slots this is the reference's layout; with fewer,
several shards live on one device and still take one launch each, which is
how one card runs the multi-shard code path (every arena reduction is per
column, so the results are the same).

Nothing here touches a device when it is imported.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_debug_mesh", "make_controller_mesh", "HARDWARE",
           "SlotMesh"]

# NVIDIA H100 SXM5 80 GB (700 W board power) data-sheet constants, under the
# reference's keys so that ``roofline_terms(hw=)`` reads either dict.
HARDWARE = {
    "peak_flops_bf16": 989.4e12,  # dense bf16 tensor-core FLOP/s, per card
    "hbm_bandwidth": 3.35e12,  # HBM3, B/s, per card
    # The reference's key for its ICI link: here one NVLink 4 link, 25 GB/s
    # each direction (18 links a card).
    "ici_link_bandwidth": 25e9,
    "hbm_bytes": 80 * 10**9,  # per card
}


@dataclasses.dataclass(frozen=True, eq=False)
class SlotMesh:
    """A named grid of slots: ``devices[i, j, ...]`` is the device of a slot.

    ``devices`` is an object array of ``torch.device`` (repeats allowed),
    ``axis_names`` names its dimensions.  Every device must exist here: a
    CUDA index past the visible cards raises, as does CUDA on a machine
    without it.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        grid = np.empty(np.shape(self.devices), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            grid[idx] = _existing(dev)
        names = tuple(self.axis_names)
        if grid.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(
                f"a {grid.ndim}-D slot grid needs {grid.ndim} distinct axis names, "
                f"got {names}"
            )
        if grid.size == 0:
            raise ValueError("a slot mesh needs at least one slot")
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> OrderedDict:
        """Axis name → number of slots along it (``jax.sharding.Mesh.shape``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def slot_devices(self, axes: tuple[str, ...]) -> tuple[torch.device, ...]:
        """The devices of the slots along ``axes``, row-major over them.

        Every other axis is taken at index 0: what is laid out over ``axes``
        alone lives once, on those slots, where the reference would replicate
        it along the other axes.
        """
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not one of the mesh's {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid.reshape(grid.shape[: len(order)] + (-1,))[..., 0]
        return tuple(grid.reshape(-1))


def _existing(dev) -> torch.device:
    """``dev`` as a ``torch.device`` with its index, refused if it does not exist."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        resolve_device(dev)  # raises without CUDA
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"slot device {dev} is not available: {torch.cuda.device_count()} "
                "CUDA device(s) visible"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported slot device {dev}; use 'cuda' or 'cpu'")
    return torch.device("cpu")


def make_controller_mesh(n_shards: int | None = None,
                         device: str | torch.device | None = None) -> SlotMesh:
    """1-D ``("data",)`` slot mesh over the controller's devices.

    The mesh the sharded arena lays its ``(n_max, P)`` buffer out on
    (``core/store.ArenaStore(mesh=...)``): ``P`` splits over ``data``, one
    column shard a slot.  ``device`` is resolved as every entry point
    resolves it — the card unless the caller asks for the CPU, raising
    without CUDA — and names the device type: ``n_shards`` of ``None`` or
    ``-1`` gives one slot per visible device of that type (every card; the
    host is one device), ``n`` gives ``n`` slots placed round-robin over
    them.  Unlike the reference, which raises when asked for more shards than
    devices, slots may share a device.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device("cpu")]
    if n_shards is None or n_shards == -1:
        n = len(visible)
    else:
        n = int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards must be >= 1, None or -1, got {n_shards!r}")
    grid = np.empty((n,), dtype=object)
    for s in range(n):
        grid[s] = visible[s % len(visible)]
    return SlotMesh(grid, ("data",))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> SlotMesh:
    """The reference's production mesh as slots: ``(16, 16)`` with axes
    ``("data", "model")``, or ``(2, 16, 16)`` with ``("pod", "data",
    "model")`` when ``multi_pod``; every slot on ``device`` (resolved as
    every entry point resolves it).  It allocates nothing: its shape drives
    ``launch/specs.py``'s arithmetic and ``launch/dryrun.py``'s share of a
    pod's aggregate on one card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    grid = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        grid[idx] = dev
    return SlotMesh(grid, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: str | torch.device | None = None) -> SlotMesh:
    """A ``(data, model)`` slot mesh, axes ``("data", "model")``, every slot
    on ``device`` (resolved as every entry point resolves it: the card unless
    the caller asks for the CPU).  One device runs each multi-slot path of
    the model axis, one slot at a time."""
    dev = resolve_device(device)
    grid = np.empty((int(data), int(model)), dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = dev
    return SlotMesh(grid, ("data", "model"))
