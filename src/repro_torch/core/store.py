"""In-memory model stores for the federation controller.

The port of ``repro/core/store.py``:

* :class:`ModelStore` — the hash-map store with per-learner lineage,
  capacity-bounded eviction and byte accounting; aggregation re-stacks its
  buffers into an ``(N, P)`` tensor every round (the ``store_mode="stack"``
  leg).
* :class:`ArenaStore` — the device-resident aggregation arena: one persistent
  ``(n_max, P)`` tensor plus ``weights``/``versions``/``mask`` vectors; every
  learner owns a row, uploads are in-place row writes, and aggregation is a
  single masked reduction straight over the arena.  With
  ``arena_dtype="int8"`` rows are resident as int8 groups plus ``(n, P/group)``
  f32 scales (~3.9x fewer bytes), written already quantized
  (:meth:`ArenaStore.write_quantized`) or quantized on write; with
  ``arena_dtype="topk"`` rows are ``(n, k)`` f32 values plus ``(n, k)`` int32
  indices of top-k *deltas* (:meth:`ArenaStore.write_sparse`), 8 bytes per
  kept coordinate instead of 4 per parameter.

The reference's donated JAX row write becomes an in-place
``buffer[row, :n].copy_(buf)``: PyTorch tensors are mutable, so the arena is
updated in place with no ``(n_max, P)`` re-allocation.

Passing ``mesh=`` (a slot mesh, ``launch/mesh.make_controller_mesh``) puts
the arena in **sharded mode**: ``buffer`` (and an int8 arena's ``scales``)
is a ``models.sharding.ColumnShards``, one ``(n_max, P/n_shards)`` tensor a
slot, each its own allocation on its slot's device; a row write splits the
upload once and copies each window into its slot's shard, and the
controller's sharded reductions reduce each shard where it lies.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import Telemetry
from repro_torch.core.packing import round_up
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as quant
from repro_torch.kernels import topk as topk_kernels
from repro_torch.models.sharding import ColumnShards, arena_specs

__all__ = ["ModelRecord", "ModelStore", "ArenaStore"]


@dataclasses.dataclass
class ModelRecord:
    """One stored local model plus its aggregation metadata."""

    learner_id: str
    round_id: int
    buffer: Any  # packed numeric buffer (torch.Tensor) or byte buffer
    num_examples: int  # aggregation weight source (FedAvg)
    metadata: dict = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the stored buffer (eviction accounting)."""
        b = self.buffer
        if hasattr(b, "nbytes"):
            return int(b.nbytes)
        return int(np.asarray(b).nbytes)


class ModelStore:
    """Hash-map model store with per-learner lineage and eviction.

    ``lineage_length`` bounds how many historical models per learner are kept
    (1 = the paper's behaviour: latest only).  ``capacity_bytes`` optionally
    bounds total resident bytes; the oldest records across learners are
    evicted first (never the latest record of a learner).
    """

    def __init__(
        self,
        lineage_length: int = 1,
        capacity_bytes: int | None = None,
        telemetry: Telemetry | None = None,
    ):
        if lineage_length < 1:
            raise ValueError("lineage_length must be >= 1")
        self._lineage_length = lineage_length
        self._capacity_bytes = capacity_bytes
        self._records: OrderedDict[str, list[ModelRecord]] = OrderedDict()
        self._telemetry = telemetry if telemetry is not None else Telemetry()
        self._register_counters()

    def _register_counters(self) -> None:
        self._c_inserts = self._telemetry.counter("store.model.total_inserts")
        self._c_bytes = self._telemetry.counter("store.model.bytes_ingested")

    def bind_telemetry(self, telemetry: Telemetry) -> None:
        """Re-register this store's counters in a shared registry (values carry over)."""
        if telemetry is self._telemetry:
            return
        inserts, nbytes = self._c_inserts.value, self._c_bytes.value
        self._telemetry = telemetry
        self._register_counters()
        self._c_inserts.add(inserts)
        self._c_bytes.add(nbytes)

    @property
    def total_inserts(self) -> int:
        """Deprecated shim for ``telemetry.value('store.model.total_inserts')``."""
        return self._c_inserts.value

    @property
    def bytes_ingested(self) -> int:
        """Deprecated shim for ``telemetry.value('store.model.bytes_ingested')``."""
        return self._c_bytes.value

    # -- insertion ---------------------------------------------------------
    def insert(self, record: ModelRecord) -> None:
        """Append to the learner's lineage, trimming history and evicting."""
        lineage = self._records.setdefault(record.learner_id, [])
        lineage.append(record)
        self._c_inserts.add(1)
        # Cumulative ingest accounting (never decremented by eviction).
        self._c_bytes.add(record.nbytes)
        if len(lineage) > self._lineage_length:
            del lineage[: len(lineage) - self._lineage_length]
        self._maybe_evict()

    def _maybe_evict(self) -> None:
        if self._capacity_bytes is None:
            return
        while self.resident_bytes() > self._capacity_bytes:
            victim: ModelRecord | None = None
            for lineage in self._records.values():
                for rec in lineage[:-1]:
                    if victim is None or rec.timestamp < victim.timestamp:
                        victim = rec
            if victim is None:
                break  # only latest-per-learner remain; never evict those
            self._records[victim.learner_id].remove(victim)

    # -- selection ---------------------------------------------------------
    def latest(self, learner_id: str) -> ModelRecord:
        """The learner's most recent record (KeyError if never uploaded)."""
        return self._records[learner_id][-1]

    def lineage(self, learner_id: str) -> list[ModelRecord]:
        """Oldest-to-newest stored history for one learner (may be empty)."""
        return list(self._records.get(learner_id, []))

    def discard(self, learner_id: str) -> None:
        """Drop a learner's entire stored lineage (no-op if unknown)."""
        self._records.pop(learner_id, None)

    def select_latest(self, learner_ids: list[str] | None = None) -> list[ModelRecord]:
        """The controller's 'model selection' step before aggregation."""
        ids = learner_ids if learner_ids is not None else list(self._records)
        return [self.latest(i) for i in ids if i in self._records]

    def __contains__(self, learner_id: str) -> bool:
        return learner_id in self._records

    def __iter__(self) -> Iterator[str]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)

    # -- accounting ---------------------------------------------------------
    def resident_bytes(self) -> int:
        """Total bytes across every stored record (drives eviction)."""
        return sum(rec.nbytes for lin in self._records.values() for rec in lin)

    def num_records(self) -> int:
        """Total stored records across all learners and lineages."""
        return sum(len(lin) for lin in self._records.values())

    # -- checkpointing ------------------------------------------------------
    def export_records(self) -> list[ModelRecord]:
        """Every stored record in insertion order (checkpoint save)."""
        return [rec for lin in self._records.values() for rec in lin]

    def restore_records(self, records: Sequence[ModelRecord]) -> None:
        """Replace the store's contents (checkpoint restore).

        Rebuilds lineages in the given order without touching the cumulative
        ingest counters: a restore is not new wire traffic.
        """
        self._records.clear()
        for rec in records:
            self._records.setdefault(rec.learner_id, []).append(rec)


# ---------------------------------------------------------------------------
# Device-resident aggregation arena
# ---------------------------------------------------------------------------


class ArenaStore:
    """Device-resident aggregation arena — the controller hot-path store.

    Owns one persistent ``(n_max, padded_params)`` tensor on ``device`` plus
    ``weights (n_max,)`` (FedAvg example counts), ``versions (n_max,)`` (the
    global-model version each row trained from) and a float validity
    ``mask (n_max,)``.  A learner is assigned a row at registration
    (:meth:`ensure_row`) and reuses it for every upload; aggregation is one
    masked reduction over ``buffer`` sliced to ``num_params``.

    Rows are padded to ``row_align`` elements (1024, as in the reference, so
    the upload wire size matches); the padding columns are zero and never
    escape.  ``arena_dtype="int8"`` keeps ``buffer`` as int8 and adds
    ``scales (n_max, padded_params/qgroup)`` f32 (``qgroup`` defaults to
    256); ``arena_dtype="topk"`` makes ``buffer`` the ``(n_max, sparse_k)``
    f32 values and adds ``indices (n_max, sparse_k)`` int32, ``sparse_k``
    clamped to the padded row width as the wire codec clamps it.  More
    learners than rows grow the arena geometrically.

    **Sharded mode** (``mesh=`` given, ``axes=`` its arena axes): ``buffer``
    and ``scales`` are ``ColumnShards`` laid out by
    ``models.sharding.arena_specs`` (``buffer_sharding``), one shard a slot on
    the slot's device; ``padded_params`` rounds up to ``row_align *
    n_shards`` so every shard is ``shard_width = padded_params / n_shards``
    columns and stays aligned; the int8 arena needs ``shard_width`` to be a
    whole number of groups.  The metadata vectors stay on ``device``, and the
    sparse ``(n, k)`` arrays stay whole.  Growth copies each shard on its own
    device.  Host
    mirrors (``_valid``, ``_weights_host``, ``_versions_host``) answer
    cohort questions without a device read.

    Thread-safety: all mutation happens under an internal re-entrant lock;
    aggregate inside ``with arena.lock:`` so no write lands mid-reduction.
    """

    def __init__(
        self,
        num_params: int,
        n_max: int = 8,
        row_align: int = 1024,
        dtype: torch.dtype = torch.float32,
        mesh: Any = None,
        axes: Any = None,
        telemetry: Telemetry | None = None,
        arena_dtype: str = "f32",
        qgroup: int | None = None,
        sparse_k: int | None = None,
        device: str | torch.device | None = None,
    ):
        if num_params < 1:
            raise ValueError("num_params must be >= 1")
        if arena_dtype not in ("f32", "int8", "topk"):
            raise ValueError(
                f"arena_dtype must be 'f32', 'int8' or 'topk', got {arena_dtype!r}"
            )
        self.device = resolve_device(device)
        self.num_params = int(num_params)
        self.dtype = dtype
        self.arena_dtype = arena_dtype
        self.lock = threading.RLock()
        self.mesh = mesh
        if mesh is not None:
            self.buffer_sharding, self.row_sharding, _ = arena_specs(mesh, axes)
            self.axes = self.buffer_sharding.axes
            self.n_shards = self.buffer_sharding.n_shards
            self.padded_params = round_up(self.num_params, row_align * self.n_shards)
        else:
            self.axes = None
            self.buffer_sharding = self.row_sharding = None
            self.n_shards = 1
            self.padded_params = round_up(self.num_params, row_align)
        if arena_dtype == "int8":
            self.qgroup = int(qgroup or quant.DEFAULT_GROUP)
            if self.shard_width % self.qgroup:
                raise ValueError(
                    f"int8 arena needs the per-shard row width {self.shard_width} "
                    f"divisible by the quant group {self.qgroup}; raise row_align "
                    "or shrink the group"
                )
            self.buffer_dtype = torch.int8
        else:
            self.qgroup = int(qgroup) if qgroup else None
            self.buffer_dtype = dtype
        if arena_dtype == "topk":
            if sparse_k is None:
                raise ValueError("arena_dtype='topk' needs sparse_k")
            self.sparse_k = max(1, min(int(sparse_k), self.padded_params))
            self.buffer_dtype = torch.float32
        else:
            self.sparse_k = None
        n = max(1, int(n_max))
        self._rows: dict[str, int] = {}
        self._valid = np.zeros((n,), bool)
        self._weights_host = np.zeros((n,), np.float32)
        self._versions_host = np.zeros((n,), np.float32)
        if arena_dtype == "topk":
            # The sparse (n, k) arrays stay whole even under a mesh: N·k is
            # small by construction, and the sharded scatter reads them whole.
            self.buffer = torch.zeros((n, self.sparse_k), dtype=torch.float32,
                                      device=self.device)
            self.indices = torch.zeros((n, self.sparse_k), dtype=torch.int32,
                                       device=self.device)
        else:
            self.buffer = self._zeros((n, self.padded_params), self.buffer_dtype)
            self.indices = None
        # Per-row per-group f32 dequantization scales of the int8 arena, laid
        # out as the rows are (a shard is a whole number of groups).
        self.scales = (
            self._zeros((n, self.padded_params // self.qgroup), torch.float32)
            if arena_dtype == "int8" else None
        )
        self.weights = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.versions = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.mask = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self._telemetry = telemetry if telemetry is not None else Telemetry()
        self._c_writes = self._telemetry.counter("store.arena.total_writes")
        self._c_bytes = self._telemetry.counter("store.arena.bytes_ingested")
        self._c_grows = self._telemetry.counter("store.arena.grow_events")
        self._g_resident = self._telemetry.gauge("store.arena.bytes_resident")
        self._g_resident.set(self.resident_bytes())

    @property
    def total_writes(self) -> int:
        """Deprecated shim for ``telemetry.value('store.arena.total_writes')``."""
        return self._c_writes.value

    @property
    def bytes_ingested(self) -> int:
        """Deprecated shim for ``telemetry.value('store.arena.bytes_ingested')``."""
        return self._c_bytes.value

    @property
    def grow_events(self) -> int:
        """Deprecated shim for ``telemetry.value('store.arena.grow_events')``."""
        return self._c_grows.value

    def _zeros(self, shape: tuple[int, int], dtype: torch.dtype):
        """A dense arena array of zeros: laid out over the mesh when sharded."""
        if self.sharded:
            return self.buffer_sharding.zeros(shape, dtype)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _laid_out(self, full: np.ndarray):
        """A host ``(n, P)`` array moved to the arena: split when sharded."""
        x = torch.from_numpy(full)
        return self.buffer_sharding.split(x) if self.sharded else x.to(self.device)

    @staticmethod
    def _host(x) -> np.ndarray:
        """An arena array on the host, shards gathered side by side."""
        if isinstance(x, ColumnShards):
            return np.concatenate([s.cpu().numpy() for s in x], axis=1)
        return x.cpu().numpy()

    # -- capacity -----------------------------------------------------------
    @property
    def n_max(self) -> int:
        """Current row capacity (grows geometrically on demand)."""
        return self.buffer.shape[0]

    @property
    def sharded(self) -> bool:
        """True when the arena's rows are column-sharded over a slot mesh."""
        return self.mesh is not None

    @property
    def shard_width(self) -> int:
        """Columns a slot holds: ``padded_params / n_shards``."""
        return self.padded_params // self.n_shards

    @staticmethod
    def _grown(old, n_new: int):
        if isinstance(old, ColumnShards):
            return ColumnShards(ArenaStore._grown(s, n_new) for s in old)
        new = torch.zeros((n_new,) + tuple(old.shape[1:]), dtype=old.dtype, device=old.device)
        new[: old.shape[0]].copy_(old)
        return new

    def _grow(self, n_new: int) -> None:
        self.buffer = self._grown(self.buffer, n_new)
        if self.indices is not None:
            self.indices = self._grown(self.indices, n_new)
        if self.scales is not None:
            self.scales = self._grown(self.scales, n_new)
        self.weights = self._grown(self.weights, n_new)
        self.versions = self._grown(self.versions, n_new)
        self.mask = self._grown(self.mask, n_new)
        pad = n_new - len(self._valid)
        self._valid = np.concatenate([self._valid, np.zeros((pad,), bool)])
        self._weights_host = np.concatenate([self._weights_host, np.zeros((pad,), np.float32)])
        self._versions_host = np.concatenate([self._versions_host, np.zeros((pad,), np.float32)])
        self._c_grows.add(1)
        self._g_resident.set(self.resident_bytes())

    def _assign_row(self, learner_id: str) -> int:
        row = self._rows.get(learner_id)
        if row is None:
            row = len(self._rows)
            if row >= self.n_max:
                self._grow(max(2 * self.n_max, row + 1))
            self._rows[learner_id] = row
        return row

    def ensure_row(self, learner_id: str) -> int:
        """Assign (or return) the learner's arena row without writing it.

        Called at registration so row order follows *registration* order,
        not arrival order — arena aggregation order is then deterministic.
        The row stays invalid until the first :meth:`write`.
        """
        with self.lock:
            return self._assign_row(learner_id)

    # -- writes -------------------------------------------------------------
    def write(
        self, learner_id: str, buffer: torch.Tensor, weight: float, version: float = 0.0
    ) -> int:
        """Insert/overwrite a learner's packed update in its arena row.

        An in-place ``copy_`` of O(P) device bytes, no allocation, no host
        copy.  On an int8 arena the row is quantized first (the kernel on the
        card) and lands through :meth:`write_quantized`; the padding columns
        quantize to ``q = 0``, scale 1.0.  A sparse arena has no dense rows
        and refuses.  Returns the row.
        """
        if self.arena_dtype == "topk":
            raise ValueError(
                "a sparse (arena_dtype='topk') arena has no dense rows; use write_sparse"
            )
        buf = torch.as_tensor(buffer).reshape(-1).to(self.device, self.dtype)
        if buf.shape[0] not in (self.num_params, self.padded_params):
            raise ValueError(
                f"buffer has {buf.shape[0]} params, arena rows hold "
                f"{self.num_params} (or {self.padded_params} pre-padded)"
            )
        if self.arena_dtype == "int8":
            buf = torch.nn.functional.pad(buf, (0, self.padded_params - buf.shape[0]))
            q, s = ops.quantize(
                buf, group=self.qgroup,
                block_rows=quant.effective_block_rows(self.padded_params, self.qgroup),
            )
            return self.write_quantized(
                learner_id, q[: self.padded_params],
                s[: self.padded_params // self.qgroup], weight, version,
            )
        if self.sharded and buf.shape[0] != self.padded_params:
            buf = torch.nn.functional.pad(buf, (0, self.padded_params - buf.shape[0]))
        with self.lock:
            row = self._assign_row(learner_id)
            self._write_row(self.buffer, row, buf)
            self.weights[row] = float(weight)
            self.versions[row] = float(version)
            self.mask[row] = 1.0
            self._valid[row] = True
            self._weights_host[row] = weight
            self._versions_host[row] = version
            self._c_writes.add(1)
            # Cumulative decoded-row ingest bytes (reconciles against uplink).
            self._c_bytes.add(int(buf.nbytes))
            return row

    def write_quantized(
        self, learner_id: str, q: torch.Tensor, scales: torch.Tensor,
        weight: float, version: float = 0.0,
    ) -> int:
        """Land an already-quantized row (int8 values + f32 group scales).

        The int8 arena's ingest hot path: an int8 upload decoded by
        ``Channel.recv_upload_quantized`` is copied in place into the row and
        its scales, with no f32 ``(P,)`` row in between; same metadata
        bookkeeping as :meth:`write`.  Only on an ``arena_dtype="int8"`` arena.
        """
        if self.arena_dtype != "int8":
            raise ValueError(
                "write_quantized requires ArenaStore(arena_dtype='int8'); "
                f"this arena is {self.arena_dtype!r}"
            )
        q = torch.as_tensor(q).reshape(-1)
        if q.dtype != torch.int8:
            raise ValueError(f"quantized row must be int8, got {q.dtype}")
        n_groups = self.padded_params // self.qgroup
        if q.shape[0] != self.padded_params or tuple(scales.shape) != (n_groups,):
            raise ValueError(
                f"quantized row holds {q.shape[0]} values / {tuple(scales.shape)} "
                f"scales; this arena wants ({self.padded_params},) / ({n_groups},)"
            )
        scales = scales.to(self.device, torch.float32)
        with self.lock:
            row = self._assign_row(learner_id)
            self._write_row(self.buffer, row, q)
            self._write_row(self.scales, row, scales)
            self.weights[row] = float(weight)
            self.versions[row] = float(version)
            self.mask[row] = 1.0
            self._valid[row] = True
            self._weights_host[row] = weight
            self._versions_host[row] = version
            self._c_writes.add(1)
            self._c_bytes.add(int(q.nbytes) + int(scales.nbytes))
            return row

    def write_sparse(
        self, learner_id: str, indices: torch.Tensor, values: torch.Tensor,
        weight: float, version: float = 0.0,
    ) -> int:
        """Land a sparse ``(indices, values)`` upload in its arena row.

        The sparse arena's ingest hot path: a topk upload decoded by
        ``Channel.recv_upload_sparse`` is copied in place into the row's
        indices and values, with no densification; same metadata bookkeeping
        as :meth:`write`.  Rows hold *deltas* against the model version
        recorded per row.  Only on an ``arena_dtype="topk"`` arena.
        """
        if self.arena_dtype != "topk":
            raise ValueError(
                "write_sparse requires ArenaStore(arena_dtype='topk'); "
                f"this arena is {self.arena_dtype!r}"
            )
        idx = torch.as_tensor(indices).reshape(-1)
        val = torch.as_tensor(values).reshape(-1).to(torch.float32)
        if idx.dtype != torch.int32:
            raise ValueError(f"sparse indices must be int32, got {idx.dtype}")
        if idx.shape[0] != self.sparse_k or val.shape[0] != self.sparse_k:
            raise ValueError(
                f"sparse row holds {idx.shape[0]} indices / {val.shape[0]} values; "
                f"this arena wants ({self.sparse_k},) each"
            )
        with self.lock:
            row = self._assign_row(learner_id)
            self.indices[row].copy_(idx)
            self.buffer[row].copy_(val)
            self.weights[row] = float(weight)
            self.versions[row] = float(version)
            self.mask[row] = 1.0
            self._valid[row] = True
            self._weights_host[row] = weight
            self._versions_host[row] = version
            self._c_writes.add(1)
            self._c_bytes.add(int(idx.nbytes) + int(val.nbytes))
            return row

    def _write_row(self, array, row: int, values: torch.Tensor) -> None:
        """Copy ``values`` into ``array[row]`` (its first ``len(values)``
        columns); split once and each window copied to its slot when sharded."""
        if isinstance(array, ColumnShards):
            start = 0
            for shard in array:
                width = int(shard.shape[1])
                shard[row].copy_(values[start: start + width])
                start += width
        else:
            array[row, : values.shape[0]].copy_(values)

    def invalidate(self, learner_id: str) -> None:
        """Drop a learner's contribution (row is kept for reuse)."""
        with self.lock:
            row = self._rows.get(learner_id)
            if row is None or not self._valid[row]:
                return
            self._valid[row] = False
            self.mask[row] = 0.0

    # -- selection ----------------------------------------------------------
    def row_of(self, learner_id: str) -> int | None:
        """The learner's assigned arena row (None before assignment)."""
        return self._rows.get(learner_id)

    def row_view(self, learner_id: str) -> torch.Tensor:
        """Device view of one learner's un-padded packed buffer (always f32).

        On an int8 arena the row is dequantized on the fly, on a sparse arena
        densified; the resident state stays as it is.
        """
        with self.lock:
            row = self._rows[learner_id]
            if not self._valid[row]:
                raise KeyError(f"{learner_id} has no valid model in the arena")
            if self.sharded:
                if self.arena_dtype == "int8":
                    parts = [(q[row].to(self.device, torch.float32).reshape(-1, self.qgroup)
                              * s[row].to(self.device)[:, None]).reshape(-1)
                             for q, s in zip(self.buffer, self.scales)]
                else:
                    parts = [shard[row].to(self.device) for shard in self.buffer]
                return torch.cat(parts)[: self.num_params]
            if self.arena_dtype == "int8":
                x = (self.buffer[row].to(torch.float32).reshape(-1, self.qgroup)
                     * self.scales[row][:, None]).reshape(-1)
                return x[: self.num_params]
            if self.arena_dtype == "topk":
                x = topk_kernels.densify(self.indices[row], self.buffer[row],
                                         self.padded_params)
                return x[: self.num_params]
            return self.buffer[row, : self.num_params]

    def weight_of(self, learner_id: str) -> float:
        """Host-mirrored aggregation weight of a learner's current upload."""
        with self.lock:
            return float(self._weights_host[self._rows[learner_id]])

    def version_of(self, learner_id: str) -> float:
        """Host-mirrored model version a learner's current upload trained from
        (the secure async path derives staleness weights from it before the
        fixed-point masking, with no device read)."""
        with self.lock:
            return float(self._versions_host[self._rows[learner_id]])

    def round_mask(self, learner_ids: Sequence[str] | None = None) -> torch.Tensor:
        """Validity mask restricted to a selection (the round's cohort).

        ``None`` selects every valid row.  The mask is the only per-round
        host-to-device transfer of the arena path: ``n_max`` floats.
        """
        with self.lock:
            if learner_ids is None:
                return self.mask
            sel = np.zeros((self.n_max,), np.float32)
            for lid in learner_ids:
                row = self._rows.get(lid)
                if row is not None and self._valid[row]:
                    sel[row] = 1.0
            return torch.from_numpy(sel).to(self.device)

    def valid_ids(self) -> list[str]:
        """Learners whose arena row currently holds a valid upload."""
        with self.lock:
            return [lid for lid, row in self._rows.items() if self._valid[row]]

    def num_valid(self, learner_ids: Sequence[str] | None = None) -> int:
        """How many of the given learners hold a valid upload (host-side, no sync)."""
        with self.lock:
            if learner_ids is None:
                return int(self._valid.sum())
            count = 0
            for lid in learner_ids:
                row = self._rows.get(lid)
                if row is not None and self._valid[row]:
                    count += 1
            return count

    # -- accounting ---------------------------------------------------------
    def __contains__(self, learner_id: str) -> bool:
        with self.lock:
            row = self._rows.get(learner_id)
            return row is not None and bool(self._valid[row])

    def __len__(self) -> int:
        with self.lock:
            return int(self._valid.sum())

    def resident_bytes(self) -> int:
        """Device bytes held by the arena (buffer + scales + metadata vectors;
        every shard's, when sharded).

        Published as the ``store.arena.bytes_resident`` gauge after every
        capacity change: the int8 arena's ``(1 + 4/group)`` bytes per param
        against 4 for f32, the sparse arena's 8 per kept coordinate.
        """
        scales = self.scales.nbytes if self.scales is not None else 0
        indices = self.indices.nbytes if self.indices is not None else 0
        return int(
            self.buffer.nbytes + scales + indices + self.weights.nbytes
            + self.versions.nbytes + self.mask.nbytes
        )

    # -- checkpointing ------------------------------------------------------
    def export_state(self) -> dict:
        """Host-side copy of the arena's full state (checkpoint save).

        Returns ``buffer`` (the full ``(n_max, padded_params)`` array, f32 or
        int8), the host ``weights``/``versions``/``valid`` mirrors and the
        ``rows`` learner→row map; an int8 arena adds ``scales`` (the
        ``(n_max, padded_params/group)`` f32 array), a sparse arena
        ``indices`` (``buffer`` is then its ``(n_max, sparse_k)`` values).
        Every round trip through ``.npz`` is bit-exact, so a restored arena
        aggregates bit-identically.
        """
        with self.lock:
            state = {
                "buffer": self._host(self.buffer),
                "weights": self._weights_host.copy(),
                "versions": self._versions_host.copy(),
                "valid": self._valid.copy(),
                "rows": dict(self._rows),
            }
            if self.scales is not None:
                state["scales"] = self._host(self.scales)
            if self.indices is not None:
                state["indices"] = self.indices.cpu().numpy()
            return state

    def restore_state(
        self,
        buffer: np.ndarray,
        weights: np.ndarray,
        versions: np.ndarray,
        valid: np.ndarray,
        rows: dict[str, int],
        scales: np.ndarray | None = None,
        indices: np.ndarray | None = None,
    ) -> None:
        """Reload a checkpointed arena state (inverse of :meth:`export_state`).

        The arena must have the same ``num_params`` and row alignment
        (``padded_params`` must match).  Capacity adapts: the restored state
        is padded (or the arena grown) to cover both the saved rows and any
        already assigned.  An int8 arena needs ``scales``; a sparse arena
        needs ``indices`` and the same ``sparse_k``.
        """
        host_dt = np.int8 if self.arena_dtype == "int8" else np.float32
        row_width = self.sparse_k if self.arena_dtype == "topk" else self.padded_params
        buffer = np.asarray(buffer, host_dt)
        if buffer.ndim != 2 or buffer.shape[1] != row_width:
            raise ValueError(
                f"checkpointed arena rows hold {buffer.shape[-1]} params, "
                f"this arena holds {row_width}"
            )
        if self.arena_dtype == "topk":
            if indices is None:
                raise ValueError("restoring a sparse arena needs the checkpointed indices")
            indices = np.asarray(indices, np.int32)
            if indices.shape != buffer.shape:
                raise ValueError(
                    f"checkpointed sparse indices have shape {indices.shape}, "
                    f"values have {buffer.shape}"
                )
        if self.arena_dtype == "int8":
            if scales is None:
                raise ValueError(
                    "restoring an int8 arena needs the checkpointed scales"
                )
            scales = np.asarray(scales, np.float32)
            n_groups = self.padded_params // self.qgroup
            if scales.ndim != 2 or scales.shape[1] != n_groups:
                raise ValueError(
                    f"checkpointed scales hold {scales.shape[-1]} groups, "
                    f"this arena wants {n_groups}"
                )
        with self.lock:
            n = max(self.n_max, buffer.shape[0], len(rows))
            full = np.zeros((n, row_width), host_dt)
            full[: buffer.shape[0]] = buffer
            self._valid = np.zeros((n,), bool)
            self._valid[: len(valid)] = np.asarray(valid, bool)
            self._weights_host = np.zeros((n,), np.float32)
            self._weights_host[: len(weights)] = np.asarray(weights, np.float32)
            self._versions_host = np.zeros((n,), np.float32)
            self._versions_host[: len(versions)] = np.asarray(versions, np.float32)
            self._rows = {str(k): int(v) for k, v in rows.items()}
            self.buffer = (torch.from_numpy(full).to(self.device)
                           if self.arena_dtype == "topk" else self._laid_out(full))
            if self.arena_dtype == "topk":
                full_i = np.zeros((n, row_width), np.int32)
                full_i[: indices.shape[0]] = indices
                self.indices = torch.from_numpy(full_i).to(self.device)
            if self.arena_dtype == "int8":
                full_s = np.zeros((n, self.padded_params // self.qgroup), np.float32)
                full_s[: scales.shape[0]] = scales
                self.scales = self._laid_out(full_s)
            self.weights = torch.from_numpy(self._weights_host.copy()).to(self.device)
            self.versions = torch.from_numpy(self._versions_host.copy()).to(self.device)
            self.mask = torch.from_numpy(self._valid.astype(np.float32)).to(self.device)
            self._g_resident.set(self.resident_bytes())
