"""Flat tensor transport: the MetisFL wire format, in PyTorch.

The port of ``repro/core/packing.py``.  A model travels as one contiguous
``uint8`` buffer plus a :class:`Manifest` (shape, dtype, offset per tensor):

* :func:`pack_bytes` / :func:`unpack_bytes` — the wire format (host bytes,
  the original dtypes bit-exactly: bf16 stays 2 bytes on the wire);
* :func:`pack_numeric` / :func:`unpack_numeric` — the aggregation format: every
  leaf flattened, cast to one accumulation dtype and concatenated into a
  single 1-D tensor, the rows of the controller's ``(N, P)`` reduction.

Leaf order and names follow the reference exactly (``repro_torch/tree.py``):
sorted dict keys, ``keystr`` names.  The JAX ``treedef`` has no counterpart;
the port's manifest carries its own :class:`~repro_torch.tree.Structure`.
The wire stays host bytes (numpy), exactly as in the reference, so byte
counts and buffers agree between the two packages.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = [
    "TensorSpec",
    "Manifest",
    "build_manifest",
    "pack_numeric",
    "unpack_numeric",
    "pack_bytes",
    "pack_bytes_from_numeric",
    "unpack_bytes",
    "pack_row_bytes",
    "unpack_row_bytes",
    "bitcast",
    "num_params",
    "round_up",
    "tree_from_numpy",
    "tree_to_numpy",
    "host_tensor",
]


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return ((n + multiple - 1) // multiple) * multiple


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype string (``"float32"``, ``"bfloat16"``...)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Structural descriptor of one tensor on the wire (a proto-tensor)."""

    name: str
    shape: tuple[int, ...]
    dtype: str  # the reference's dtype string, e.g. "float32", "bfloat16"
    offset: int  # element offset into the numeric buffer
    size: int  # number of elements

    @property
    def nbytes(self) -> int:
        """Wire size of this tensor in bytes (original dtype)."""
        return self.size * torch_dtype(self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Full structural description of a packed model.

    ``specs`` are in the reference's walk order; ``structure`` rebuilds the
    container tree.  ``byteorder`` is recorded as MetisFL's proto does.
    """

    specs: tuple[TensorSpec, ...]
    structure: tree_util.Structure
    byteorder: str = "little"

    @property
    def total_elements(self) -> int:
        """Total scalar element count across every packed tensor."""
        return sum(s.size for s in self.specs)

    @property
    def total_bytes(self) -> int:
        """Total wire bytes across every packed tensor."""
        return sum(s.nbytes for s in self.specs)

    def spec_by_name(self, name: str) -> TensorSpec:
        """Look up one tensor's spec by its key-path name."""
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)


def build_manifest(params: Any) -> Manifest:
    """Build the structural manifest for a parameter tree.

    Offsets index the accumulation-dtype buffer of :func:`pack_numeric` (one
    element per original element, whatever the original dtype).
    """
    named, structure = tree_util.flatten_with_path(params)
    specs = []
    offset = 0
    for name, leaf in named:
        leaf = torch.as_tensor(leaf)
        size = leaf.numel()
        specs.append(
            TensorSpec(
                name=name,
                shape=tuple(int(d) for d in leaf.shape),
                dtype=dtype_name(leaf.dtype),
                offset=offset,
                size=size,
            )
        )
        offset += size
    return Manifest(specs=tuple(specs), structure=structure)


def num_params(params: Any) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(torch.as_tensor(leaf).numel() for leaf in tree_util.flatten(params)[0])


# ---------------------------------------------------------------------------
# Numeric packing (aggregation format)
# ---------------------------------------------------------------------------


def pack_numeric(
    params: Any, dtype: torch.dtype = torch.float32, pad_to: int | None = None
) -> torch.Tensor:
    """Flatten a tree into one 1-D tensor in the accumulation dtype.

    ``pad_to`` zero-pads the length up to the next multiple — the arena's
    row alignment, so an aligned upload is one full-row write.  The buffer
    lands on the leaves' device.
    """
    leaves = tree_util.flatten(params)[0]
    if not leaves:
        buf = torch.zeros((0,), dtype=dtype)
    else:
        buf = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    if pad_to is not None and buf.shape[0] % pad_to:
        buf = torch.nn.functional.pad(buf, (0, round_up(buf.shape[0], pad_to) - buf.shape[0]))
    return buf


def unpack_numeric(buffer: torch.Tensor, manifest: Manifest) -> Any:
    """Inverse of :func:`pack_numeric`: restore shapes, dtypes and structure.

    Leaves whose dtype matches the buffer's are views of it.
    """
    leaves = [
        buffer[s.offset : s.offset + s.size].reshape(s.shape).to(torch_dtype(s.dtype))
        for s in manifest.specs
    ]
    return tree_util.unflatten(manifest.structure, leaves)


# ---------------------------------------------------------------------------
# Byte packing (wire format)
# ---------------------------------------------------------------------------


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a ``uint8`` numpy view (any dtype, bf16 too)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def host_tensor(wire: np.ndarray, device: torch.device) -> torch.Tensor:
    """Wire bytes as a fresh ``uint8`` tensor on ``device`` (always a copy).

    Wire buffers are read-only numpy arrays; the copy (an H2D transfer on the
    card, a clone on the host) keeps the receiver's tensors independent of
    the shared envelope.
    """
    with warnings.catch_warnings():
        # from_numpy warns on read-only arrays; the tensor is copied at once.
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(wire).reshape(-1))
    return src.to(device, copy=True)


def pack_bytes(params: Any) -> tuple[np.ndarray, Manifest]:
    """Serialize a tree to one contiguous host byte buffer.

    Preserves the original dtypes bit-exactly.  Each tensor's bytes are
    copied once into a preallocated wire buffer.
    """
    manifest = build_manifest(params)
    out = np.empty((manifest.total_bytes,), np.uint8)
    cursor = 0
    for leaf in tree_util.flatten(params)[0]:
        raw = _host_bytes(leaf.detach().cpu())
        out[cursor : cursor + raw.size] = raw
        cursor += raw.size
    return out, manifest


def pack_bytes_from_numeric(buffer: torch.Tensor, manifest: Manifest) -> np.ndarray:
    """Wire bytes straight off a flat numeric buffer — no tree walk.

    One device-to-host transfer of the logical prefix, then one cast when the
    model is dtype-homogeneous, or one cast per spec otherwise.  A padded tail
    is sliced off.  Bit-identical to
    ``pack_bytes(unpack_numeric(buffer, manifest))[0]``, and always a fresh
    copy, never an alias of ``buffer``.
    """
    if not manifest.specs:
        return np.empty((0,), np.uint8)
    host = buffer.detach()[: manifest.total_elements].cpu()
    dtypes = {s.dtype for s in manifest.specs}
    if len(dtypes) == 1:
        dt = torch_dtype(next(iter(dtypes)))
        return _host_bytes(host.to(dt, copy=True))
    out = np.empty((manifest.total_bytes,), np.uint8)
    cursor = 0
    for spec in manifest.specs:
        seg = host[spec.offset : spec.offset + spec.size].to(torch_dtype(spec.dtype))
        out[cursor : cursor + spec.nbytes] = _host_bytes(seg)
        cursor += spec.nbytes
    return out


def pack_row_bytes(buffer: torch.Tensor, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Wire bytes of one flat ``(P,)`` numeric buffer (the upload row format).

    One device-to-host transfer plus one cast/copy, then a byte view; never an
    alias of the caller's buffer.  ``P * itemsize`` bytes.
    """
    return _host_bytes(buffer.detach().reshape(-1).to("cpu", dtype, copy=True))


def bitcast(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a ``uint8`` segment as ``dtype`` (copying if misaligned)."""
    if dtype == torch.bool:
        return seg.to(torch.bool)
    if seg.storage_offset() % dtype.itemsize:
        seg = seg.clone()
    return seg.view(dtype)


def unpack_row_bytes(
    wire: np.ndarray, num_elements: int, dtype: str = "float32",
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Inverse of :func:`pack_row_bytes`: one transfer, then a bitcast."""
    dt = torch_dtype(dtype)
    if int(np.size(wire)) != int(num_elements) * dt.itemsize:
        raise ValueError(
            f"row payload holds {int(np.size(wire))} bytes, expected "
            f"{int(num_elements) * dt.itemsize} for {num_elements} "
            f"{dtype} elements"
        )
    return bitcast(host_tensor(wire, torch.device(device)), dt)


def unpack_bytes(
    buffer: np.ndarray, manifest: Manifest, device: torch.device | str = "cpu"
) -> Any:
    """Inverse of :func:`pack_bytes`: one transfer of the whole wire buffer,
    then device-side slices and bitcasts per tensor."""
    if not manifest.specs:
        return tree_util.unflatten(manifest.structure, [])
    dev = host_tensor(buffer, torch.device(device))
    leaves = []
    cursor = 0
    for spec in manifest.specs:
        seg = dev[cursor : cursor + spec.nbytes]
        leaves.append(bitcast(seg, torch_dtype(spec.dtype)).reshape(spec.shape))
        cursor += spec.nbytes
    return tree_util.unflatten(manifest.structure, leaves)


# ---------------------------------------------------------------------------
# Carrying trees across frameworks
# ---------------------------------------------------------------------------


def tree_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """A tree of numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray, p)``)
    as the port's tree of tensors on ``device``, names and order kept.

    bf16 arrays (numpy's ``ml_dtypes`` ``bfloat16``) are carried bit-exactly.
    """

    def conv(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
            return bits.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return tree_util.tree_map(conv, tree)


def tree_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`tree_from_numpy`: host numpy arrays, bf16 as raw
    ``int16`` bit patterns viewed back through ``ml_dtypes`` when present."""

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().copy()
            try:
                import ml_dtypes
            except ImportError:  # no bf16 numpy type: hand back the raw bits
                return bits
            return bits.view(ml_dtypes.bfloat16)
        return t.numpy().copy()

    return tree_util.tree_map(conv, tree)
