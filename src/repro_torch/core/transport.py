"""Simulated transport layer with measured (de)serialization and byte counts.

The port of ``repro/core/transport.py`` (one device).  The
transport is an in-process channel that does the *real* serialization work,
counts bytes and accounts virtual wire time from a bandwidth/latency model,
without sleeping.  It is full duplex:

* :meth:`Channel.broadcast` — the downlink fan-out: serialize **once** into a
  shared read-only byte buffer (straight off the controller's flat
  ``global_buffer``, or through the int8 ``QuantCodec`` when the channel has
  one), then stamp per-recipient envelopes with :meth:`Broadcast.to`, each
  charging that recipient's bytes and wire time;
* :meth:`Channel.upload` / :meth:`Channel.recv_upload` — the uplink: a
  learner's flat ``(P,)`` row is encoded by the ``raw`` codec (f32 bytes) or
  the ``int8`` codec (blockwise int8 values + f32 group scales, ~3.9x fewer
  bytes) into an :class:`UploadEnvelope`; the controller decodes it with one
  host-to-device transfer into a row ready for the arena, or, for the int8
  arena, straight into quantized form (:meth:`Channel.recv_upload_quantized`);
  the ``topk`` codec ships the ``k`` largest-magnitude coordinates of a
  learner's *delta* as ``(int32 indices, f32 | int8-grouped values)``, which
  the controller densifies or, for the sparse arena, lands as-is
  (:meth:`Channel.recv_upload_sparse`).

The wire stays host bytes (numpy) exactly as in the reference, so uplink and
downlink byte counts equal the reference's for the same run: on the card,
only the wire bytes cross to the host, by one DMA into page-locked host
memory (``packing.pinned_bytes``), and back by one DMA out of it.  All
stats mutation is lock-guarded: learners upload concurrently from executor
threads.  Each timed half is a span (``core/tracing.py``), named for the
side that runs it; its seconds are the ``channel.*_s`` counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core import packing, tracing
from repro_torch.core.metrics import Telemetry
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as quant
from repro_torch.kernels import topk as topk_kernels

__all__ = [
    "ChannelStats", "Channel", "Envelope", "Broadcast",
    "UploadEnvelope", "RawUploadCodec", "Int8UploadCodec", "TopkUploadCodec",
    "UPLOAD_CODECS", "get_upload_codec",
]


#: The channel's telemetry counter names (registered as ``channel.<field>``).
_STAT_FIELDS = (
    "messages", "bytes_moved", "serializations", "serialize_s",
    "deserialize_s", "virtual_wire_s", "upload_messages", "upload_bytes",
    "upload_meta_bytes", "upload_serializations", "upload_serialize_s",
    "upload_deserialize_s", "upload_virtual_wire_s",
)

#: A CUDA channel's counters of the wires that crossed between the card and
#: the host through page-locked memory and through pageable memory: one
#: count a serialization (broadcast, send, an upload's encode) and a decode
#: (a learner's receive, the controller's decode of an upload).  A host
#: channel registers neither.
_COPY_FIELDS = ("pinned_copies", "pageable_copies")


class ChannelStats:
    """Transport accounting for one channel — a read view over its telemetry.

    Downlink: ``messages``/``bytes_moved``/``virtual_wire_s`` count per
    recipient; ``serializations``/``serialize_s`` count serialization work (a
    broadcast to N learners counts 1).  Uplink: ``upload_bytes`` is the codec
    payload, ``upload_meta_bytes`` the serialized envelope header, and
    ``upload_virtual_wire_s`` covers both.
    """

    def __init__(self, telemetry: Telemetry | None = None):
        self._telemetry = telemetry if telemetry is not None else Telemetry()

    @property
    def total_bytes(self) -> int:
        """Bytes moved across both wire directions (downlink + uplink)."""
        return self.bytes_moved + self.upload_bytes

    @property
    def total_virtual_wire_s(self) -> float:
        """Modeled wire time across both directions."""
        return self.virtual_wire_s + self.upload_virtual_wire_s

    def __repr__(self) -> str:
        fields = ", ".join(f"{f}={getattr(self, f)!r}" for f in _STAT_FIELDS)
        return f"ChannelStats({fields})"


def _stats_view_property(field: str) -> property:
    """Build one ChannelStats read property over ``channel.<field>``."""

    def _get(self: ChannelStats):
        return self._telemetry.value(f"channel.{field}", 0)

    _get.__name__ = field
    _get.__doc__ = f"Read view of ``telemetry.value('channel.{field}')``."
    return property(_get)


for _field in _STAT_FIELDS + _COPY_FIELDS:
    setattr(ChannelStats, _field, _stats_view_property(_field))
del _field


# ---------------------------------------------------------------------------
# Upload codecs (uplink wire formats)
# ---------------------------------------------------------------------------


class RawUploadCodec:
    """Passthrough upload codec: f32 row bytes on the wire (4 bytes/param).

    Bit-transparent: ``decode(encode(x)) == x`` for any float32 buffer.
    """

    codec_id = "raw"

    def wire_params(self) -> dict:
        """Codec parameters a receiver needs to decode (none for raw)."""
        return {}

    def wire_nbytes(self, num_elements: int) -> int:
        """Modeled wire payload size for a buffer of ``num_elements``."""
        return 4 * int(num_elements)

    def encode(self, buffer: torch.Tensor) -> np.ndarray:
        """Flat ``(P,)`` numeric buffer → its f32 wire bytes (one copy)."""
        return packing.pack_row_bytes(buffer, torch.float32)

    def decode(self, payload: np.ndarray, num_elements: int,
               device: torch.device) -> torch.Tensor:
        """Wire bytes → f32 ``(P,)`` row on ``device`` (one transfer)."""
        return packing.unpack_row_bytes(payload, num_elements, "float32", device)

    def decode_with_norm(
        self, payload: np.ndarray, num_elements: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode plus the row's L2 norm as an unread device scalar.

        The admission screen's fast path: the norm is enqueued right behind
        the decode, so the controller's only host sync per upload is reading
        that one scalar.
        """
        row = self.decode(payload, num_elements, device)
        return row, torch.linalg.vector_norm(row)


def _wire_bytes(wire: torch.Tensor) -> np.ndarray:
    """An encoder's ``uint8`` wire tensor as host bytes: off the card one DMA
    into page-locked memory, on the host the tensor's own memory."""
    return packing.pinned_bytes(wire) if wire.is_cuda else wire.cpu().numpy()


def _split_quant_wire(
    wire: torch.Tensor, n_q: int, n_scales: int, n_groups: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side split of one int8 upload payload into ``(q int8, scales f32)``.

    The wire carries only the ``n_scales = ceil(n/group)`` informative scales
    (``kernels/quantize.wire_layout``); the remaining ``n_groups - n_scales``
    trailing groups are re-synthesized here as exactly 1.0, the quantize
    kernel's zero-amax scale, so the round trip matches an untrimmed wire.
    """
    q = wire[:n_q].view(torch.int8)
    scales = packing.bitcast(wire[n_q: n_q + 4 * n_scales], torch.float32)
    if n_groups > n_scales:
        pad = torch.ones((n_groups - n_scales,), dtype=torch.float32, device=wire.device)
        scales = torch.cat([scales, pad])
    return q, scales


def _int8_decode_norm(
    wire: torch.Tensor, n_q: int, n_scales: int, num_elements: int, group: int,
    block_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split + re-pad + dequantize (the kernel on the card) + the row's L2 norm."""
    q, scales = _split_quant_wire(wire, n_q, n_scales, n_q // group)
    row = ops.dequantize(q, scales, num_elements, group=group, block_rows=block_rows)
    return row, torch.linalg.vector_norm(row)


def _decode_quant_resident(
    wire: torch.Tensor, n_q: int, n_scales: int, out_params: int, group: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Land one int8 upload in quantized form: ``(q int8, scales f32, norm)``.

    Split the wire, re-pad the trimmed scales and slice to the arena row
    width; no f32 ``(P,)`` row is built.  The admission norm comes from the
    quantized form, ``sqrt(Σ_g scale_g² · Σ_i q_{g,i}²)``, which equals the L2
    norm of the dequantized row up to f32 summation order.
    """
    q, scales = _split_quant_wire(wire, n_q, n_scales, n_q // group)
    q = q[:out_params]
    scales = scales[: out_params // group]
    qf = q.to(torch.float32).reshape(out_params // group, group)
    norm = torch.sqrt(torch.sum(scales * scales * torch.sum(qf * qf, dim=1)))
    return q, scales, norm


class Int8UploadCodec:
    """Blockwise-int8 upload codec (``kernels/quantize``): ~3.9x fewer bytes.

    Encode quantizes the learner's flat ``(P,)`` buffer (the hand-written
    kernel on the card; symmetric per-group scales) and concatenates the
    ``int8`` values and the informative ``f32`` scales into one wire payload,
    byte-identical to the reference's.  The block height adapts to the buffer
    (``kernels/quantize.effective_block_rows``), so padding stays within
    ~6.25% of the rows.  Decode is one host-to-device transfer of the
    payload, a device-side split and the dequantize kernel.  Lossy to the
    int8 step; use ``raw`` where bit-identity matters.
    """

    codec_id = "int8"

    def __init__(self, group: int | None = None, block_rows: int | None = None):
        self.group = int(group or quant.DEFAULT_GROUP)
        self.block_rows = int(block_rows or quant.DEFAULT_BLOCK_ROWS)

    def wire_params(self) -> dict:
        """Codec parameters the receiver needs to derive the wire layout."""
        return {"group": self.group, "block_rows": self.block_rows}

    def wire_nbytes(self, num_elements: int) -> int:
        """Modeled wire payload size: int8 values + f32 scales."""
        return quant.wire_layout(int(num_elements), self.group, self.block_rows)[2]

    def _block_rows(self, num_elements: int) -> int:
        return quant.effective_block_rows(int(num_elements), self.group, self.block_rows)

    def encode(self, buffer: torch.Tensor) -> np.ndarray:
        """Quantize a flat ``(P,)`` buffer into int8 values + f32 scales.

        Only the ``ceil(P/group)`` informative scales go on the wire; trailing
        pure-padding groups (``q == 0``, scale 1.0) are re-synthesized by the
        decoder from ``P`` alone.  ``ops.quantize`` writes ``q`` and the
        scales into one buffer in the wire's layout, so the wire is its
        prefix: one kernel and one device-to-host transfer.
        """
        flat = torch.as_tensor(buffer).reshape(-1).to(torch.float32)
        n = int(flat.shape[0])
        q, scales = ops.quantize(flat, group=self.group, block_rows=self._block_rows(n))
        n_scales = quant.wire_layout(n, self.group, self.block_rows)[1]
        return _wire_bytes(quant.wire_prefix(q, scales, n_scales))

    def _checked_layout(self, payload: np.ndarray, num_elements: int) -> tuple[int, int]:
        """Validate payload size against the wire layout; return (n_q, n_scales)."""
        n_q, n_scales, nbytes = quant.wire_layout(num_elements, self.group, self.block_rows)
        if int(payload.size) != nbytes:
            raise ValueError(
                f"int8 payload holds {int(payload.size)} bytes, expected "
                f"{nbytes} for {num_elements} elements"
            )
        return n_q, n_scales

    def decode(self, payload: np.ndarray, num_elements: int,
               device: torch.device) -> torch.Tensor:
        """Dequantize an int8 payload back to the f32 ``(P,)`` row on ``device``."""
        return self.decode_with_norm(payload, num_elements, device)[0]

    def decode_with_norm(
        self, payload: np.ndarray, num_elements: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode plus the row's L2 norm as an unread device scalar."""
        n_q, n_scales = self._checked_layout(payload, num_elements)
        wire = packing.host_tensor(payload, device)
        return _int8_decode_norm(wire, n_q, n_scales, int(num_elements), self.group,
                                 self._block_rows(num_elements))

    def decode_quantized(
        self, payload: np.ndarray, num_elements: int, out_params: int,
        device: torch.device,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode an int8 payload straight into arena-resident quantized form.

        Returns ``(q int8 (out_params,), scales f32 (out_params//group,),
        norm)`` with no intermediate f32 ``(P,)`` row.  ``out_params`` (the
        arena's padded row width) must be a multiple of ``group`` and at most
        the payload's padded element count.
        """
        n_q, n_scales = self._checked_layout(payload, num_elements)
        out_params = int(out_params)
        if out_params % self.group or out_params > n_q:
            raise ValueError(
                f"out_params={out_params} must be a multiple of group={self.group} "
                f"and <= the payload's {n_q} padded elements"
            )
        wire = packing.host_tensor(payload, device)
        return _decode_quant_resident(wire, n_q, n_scales, out_params, self.group)


def _split_topk_wire(
    wire: torch.Tensor, k_eff: int, n_scales: int, group: int, value_dtype: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-side split of one topk payload into ``(idx int32, val f32, norm)``.

    Bitcast the int32 index block, bitcast (f32 values) or bitcast and
    dequantize (int8-grouped values) the value block, and take the sparse L2
    norm: top-k indices are unique within one upload, so ``‖val‖₂`` is the
    norm of the densified row, the scalar the admission screen reads.
    """
    idx = packing.bitcast(wire[: 4 * k_eff], torch.int32)
    if value_dtype == "f32":
        val = packing.bitcast(wire[4 * k_eff: 8 * k_eff], torch.float32)
    else:
        q = wire[4 * k_eff: 5 * k_eff].view(torch.int8)
        scales = packing.bitcast(wire[5 * k_eff: 5 * k_eff + 4 * n_scales], torch.float32)
        val = topk_kernels.dequantize_values(q, scales, group)
    return idx, val, torch.linalg.vector_norm(val)


def _topk_decode_norm(
    wire: torch.Tensor, k_eff: int, n_scales: int, group: int, value_dtype: str,
    num_elements: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split and densify into a ``(num_elements,)`` delta row, plus the norm.

    The densify path for consumers that need a dense row (``sparse_mode=
    "densify"``, the stack store, the robust rules); the direct sparse path
    never calls this.
    """
    idx, val, norm = _split_topk_wire(wire, k_eff, n_scales, group, value_dtype)
    return topk_kernels.densify(idx, val, num_elements), norm


class TopkUploadCodec:
    """Magnitude top-k upload codec (``kernels/topk``): the 10-100x regime.

    Encodes the ``k`` largest-|x| coordinates of the learner's flat ``(P,)``
    **delta** buffer as ``(indices:int32, values:f32|int8-grouped)``; at
    ``k = P/64`` with f32 values the payload is ``P/8`` bytes, 32x below raw.
    Lossy per upload; the learner's error-feedback residual
    (``core/learner.py``) carries the unsent mass forward.  ``k`` clamps per
    buffer to ``[1, P]`` and ``k_eff`` is re-derived from ``num_elements`` on
    the decode side, so the envelope's ``codec_params`` stay constant.

    This codec moves deltas, not parameters: the controller adds the
    aggregated delta onto the global buffer at commit.  Selection runs on the
    buffer's device; the wire is its bytes on the host, byte-identical to the
    reference's.
    """

    codec_id = "topk"

    def __init__(self, k: int = 64, value_dtype: str = "f32", group: int | None = None):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"topk codec needs k >= 1, got {k!r}")
        if value_dtype not in topk_kernels.VALUE_DTYPES:
            raise ValueError(
                f"value_dtype must be one of {topk_kernels.VALUE_DTYPES}, "
                f"got {value_dtype!r}"
            )
        self.value_dtype = str(value_dtype)
        self.group = int(group or topk_kernels.DEFAULT_VALUE_GROUP)
        if self.group < 1:
            raise ValueError(f"topk codec needs group >= 1, got {group!r}")

    def wire_params(self) -> dict:
        """Codec parameters the receiver needs to derive the wire layout."""
        return {"k": self.k, "value_dtype": self.value_dtype, "group": self.group}

    def wire_nbytes(self, num_elements: int) -> int:
        """Modeled wire payload size: int32 indices + (f32 | int8 + scale) values."""
        return topk_kernels.wire_layout_topk(
            int(num_elements), self.k, self.value_dtype, self.group)[2]

    def encode(self, buffer: torch.Tensor) -> np.ndarray:
        """Select top-k by magnitude and pack ``(indices, values)`` bytes.

        The wire is assembled on the buffer's device and crosses to the host
        in one transfer.
        """
        flat = torch.as_tensor(buffer).reshape(-1).to(torch.float32)
        k_eff = topk_kernels.effective_k(int(flat.shape[0]), self.k)
        idx, val = topk_kernels.topk_select(flat, k_eff)
        if self.value_dtype == "f32":
            parts = [idx, val]
        else:
            parts = [idx, *topk_kernels.quantize_values(val, self.group)]
        return _wire_bytes(torch.cat([p.contiguous().view(torch.uint8) for p in parts]))

    def _checked_layout(self, payload: np.ndarray, num_elements: int) -> tuple[int, int]:
        """Validate payload size against the layout; return ``(k_eff, n_scales)``."""
        k_eff, n_scales, nbytes = topk_kernels.wire_layout_topk(
            int(num_elements), self.k, self.value_dtype, self.group)
        if int(payload.size) != nbytes:
            raise ValueError(
                f"topk payload holds {int(payload.size)} bytes, expected "
                f"{nbytes} for {num_elements} elements at k={self.k}"
            )
        return k_eff, n_scales

    def _split(self, payload: np.ndarray, num_elements: int, device: torch.device):
        k_eff, n_scales = self._checked_layout(payload, num_elements)
        wire = packing.host_tensor(payload, device)
        return _split_topk_wire(wire, k_eff, n_scales, self.group, self.value_dtype)

    def unpack_coords(
        self, payload: np.ndarray, num_elements: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Wire bytes → ``(indices int32, values f32)`` on ``device``.

        The learner's half of the error-feedback subtraction: values come back
        dequantized, exactly what the controller will see, so ``residual -=
        sent`` carries the quantization error too.
        """
        idx, val, _ = self._split(payload, num_elements, device)
        return idx, val

    def decode(self, payload: np.ndarray, num_elements: int,
               device: torch.device) -> torch.Tensor:
        """Densify a sparse payload into the f32 ``(P,)`` delta row on ``device``."""
        return self.decode_with_norm(payload, num_elements, device)[0]

    def decode_with_norm(
        self, payload: np.ndarray, num_elements: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Densify plus the L2 norm as an unread device scalar."""
        k_eff, n_scales = self._checked_layout(payload, num_elements)
        wire = packing.host_tensor(payload, device)
        return _topk_decode_norm(wire, k_eff, n_scales, self.group, self.value_dtype,
                                 int(num_elements))

    def decode_sparse(
        self, payload: np.ndarray, num_elements: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode to sparse ``(indices, values, norm)`` — no densification.

        The sparse arena's ingest half: one host-to-device transfer and a
        device-side split; the norm (the sparse L2, equal to the dense row's)
        stays an unread device scalar.
        """
        return self._split(payload, num_elements, device)


UPLOAD_CODECS = {"raw": RawUploadCodec, "int8": Int8UploadCodec, "topk": TopkUploadCodec}


def _codec_params(codec: Any) -> dict:
    """The codec's self-describing wire parameters ({} if it declares none)."""
    wire_params = getattr(codec, "wire_params", None)
    return wire_params() if wire_params is not None else {}


def get_upload_codec(spec: Any) -> Any:
    """Resolve an upload codec: a registry id (``"raw"``/``"int8"``/``"topk"``),
    an already-constructed codec object, or ``None`` (raw)."""
    if spec is None:
        return RawUploadCodec()
    if isinstance(spec, str):
        try:
            return UPLOAD_CODECS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown upload codec {spec!r}; known: {sorted(UPLOAD_CODECS)}"
            ) from None
    if not isinstance(getattr(spec, "codec_id", None), str):
        raise ValueError(
            "an upload codec object must define a string `codec_id` "
            f"attribute; got {type(spec).__name__}"
        )
    return spec


@dataclasses.dataclass(frozen=True)
class UploadEnvelope:
    """One learner→controller message on the wire.

    ``payload`` is the codec's read-only byte buffer; ``codec`` names the
    encoding and ``codec_params`` its layout parameters; ``num_elements`` is
    the logical ``(P,)`` length the payload decodes to.
    """

    codec: str
    payload: np.ndarray
    num_elements: int
    metadata: dict
    codec_params: dict = dataclasses.field(default_factory=dict)

    @property
    def meta_nbytes(self) -> int:
        """Serialized size of the envelope header (everything but payload).

        Canonical JSON (sorted keys, no whitespace) over the codec id,
        element count, metadata and codec params; counted in
        ``channel.upload_meta_bytes``.
        """
        return len(json.dumps(
            {
                "codec": self.codec,
                "num_elements": int(self.num_elements),
                "metadata": self.metadata,
                "codec_params": self.codec_params,
            },
            sort_keys=True, separators=(",", ":"), default=str,
        ).encode("utf-8"))

    @property
    def wire_nbytes(self) -> int:
        """Total uplink bytes this envelope occupies: payload + header."""
        return int(self.payload.nbytes) + self.meta_nbytes


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One downlink message: shared byte buffer + manifest + metadata."""

    buffer: np.ndarray
    manifest: packing.Manifest
    metadata: dict


class Broadcast:
    """One serialized payload fanned out to many recipients.

    The byte buffer and manifest are serialized exactly once and shared
    read-only; :meth:`to` mints a per-recipient :class:`Envelope` and charges
    that recipient's bytes and virtual wire time.  Thread-safe.
    """

    def __init__(
        self,
        channel: "Channel",
        buffer: np.ndarray,
        manifest: packing.Manifest,
        metadata: dict,
    ):
        buffer.flags.writeable = False  # shared across recipients
        self._channel = channel
        self.buffer = buffer
        self.manifest = manifest
        self._metadata = metadata
        self._lock = threading.Lock()
        self.recipients = 0

    def to(self, metadata: dict | None = None) -> Envelope:
        """Mint one recipient's envelope: shared bytes, fresh metadata."""
        md = dict(self._metadata)
        if metadata:
            md.update(metadata)
        self._channel._account_send(int(self.buffer.nbytes), md.get("learner_id"))
        with self._lock:
            self.recipients += 1
        return Envelope(buffer=self.buffer, manifest=self.manifest, metadata=md)


class Channel:
    """A measured full-duplex channel (controller <-> learner).

    ``bandwidth_gbps``/``latency_ms`` feed the virtual wire-time account and
    never block.  ``quantize_codec`` optionally compresses the downlink tree
    (``kernels/ops.QuantCodec``); it is kept as :attr:`codec`.
    ``upload_codec`` selects the uplink wire format (``"raw"``, ``"int8"`` or
    a codec object).  ``device`` is where received tensors land (downlink
    models and decoded upload rows).  All wire accounting lives as
    ``channel.*`` counters in ``telemetry``; ``stats`` is the
    :class:`ChannelStats` read view.
    """

    def __init__(
        self,
        bandwidth_gbps: float = 10.0,
        latency_ms: float = 0.5,
        quantize_codec: Any | None = None,
        upload_codec: Any = "raw",
        telemetry: Telemetry | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.bandwidth_gbps = bandwidth_gbps
        self.latency_ms = latency_ms
        self.learner_bandwidth_gbps: dict[str, float] = {}
        self.codec = quantize_codec
        self.upload_codec = get_upload_codec(upload_codec)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._c = {f: self.telemetry.counter(f"channel.{f}") for f in _STAT_FIELDS}
        if self.device.type == "cuda":
            self._c.update({f: self.telemetry.counter(f"channel.{f}") for f in _COPY_FIELDS})
        self.stats = ChannelStats(self.telemetry)
        self._stats_lock = threading.Lock()

    def set_learner_bandwidth(self, learner_id: str, gbps: float) -> None:
        """Cap one learner's modeled bandwidth (both wire halves)."""
        if gbps <= 0:
            raise ValueError(f"bandwidth cap must be positive, got {gbps}")
        self.learner_bandwidth_gbps[learner_id] = float(gbps)

    # -- accounting ---------------------------------------------------------
    def _wire_time(self, nbytes: int, learner_id: str | None = None) -> float:
        gbps = self.learner_bandwidth_gbps.get(learner_id, self.bandwidth_gbps)
        return self.latency_ms / 1e3 + nbytes * 8 / (gbps * 1e9)

    def round_trip_s(
        self, down_nbytes: int, up_nbytes: int, learner_id: str | None = None
    ) -> float:
        """Modeled round-trip wire time for one dispatch + one upload."""
        return (self._wire_time(int(down_nbytes), learner_id)
                + self._wire_time(int(up_nbytes), learner_id))

    def _account_send(self, nbytes: int, learner_id: str | None = None) -> None:
        with self._stats_lock:
            self._c["messages"].add(1)
            self._c["bytes_moved"].add(nbytes)
            self._c["virtual_wire_s"].add(self._wire_time(nbytes, learner_id))

    def _account_copy(self, span: tracing.Span, wire: np.ndarray) -> None:
        """On a CUDA channel, count one wire crossing between the card and the
        host as pinned or pageable, and note which on its span."""
        if self.device.type != "cuda":
            return
        pinned = packing.wire_is_pinned(wire)
        with self._stats_lock:
            self._c["pinned_copies" if pinned else "pageable_copies"].add(1)
        span.fields["pinned"] = pinned

    def _account_serialize(self, dt: float) -> None:
        with self._stats_lock:
            self._c["serializations"].add(1)
            self._c["serialize_s"].add(dt)

    # -- send halves --------------------------------------------------------
    def send(self, params: Any, metadata: dict | None = None) -> Envelope:
        """Serialize a tree for one recipient (the per-send half), timed by
        the span ``controller.send``."""
        with tracing.Span("controller.send") as span:
            if self.codec is not None:
                params = self.codec.encode(params)
            buf, manifest = packing.pack_bytes(params)
            span.fields["bytes"] = int(buf.nbytes)
            self._account_copy(span, buf)
        self._account_serialize(span.seconds)
        self._account_send(int(buf.nbytes))
        return Envelope(buffer=buf, manifest=manifest, metadata=dict(metadata or {}))

    def broadcast(
        self,
        params: Any = None,
        metadata: dict | None = None,
        *,
        buffer: torch.Tensor | None = None,
        manifest: packing.Manifest | None = None,
        version: int | None = None,
    ) -> Broadcast:
        """Serialize **once** for a fan-out; recipients pay only wire time.

        With ``buffer=``/``manifest=`` (the controller's flat ``global_buffer``
        and its cached manifest) and no codec, the wire bytes come straight off
        the flat buffer; otherwise ``pack_bytes`` of ``params``, encoded by the
        codec when there is one.  Timed by the span ``controller.broadcast``,
        which records ``version`` (the model version sent) and the bytes.
        """
        with tracing.Span("controller.broadcast", version=version) as span:
            if buffer is not None and manifest is not None and self.codec is None:
                wire, m = packing.pack_bytes_from_numeric(buffer, manifest), manifest
            else:
                src = params if self.codec is None else self.codec.encode(params)
                wire, m = packing.pack_bytes(src)
            span.fields["bytes"] = int(wire.nbytes)
            self._account_copy(span, wire)
        self._account_serialize(span.seconds)
        return Broadcast(self, wire, m, dict(metadata or {}))

    # -- receive ------------------------------------------------------------
    def recv(self, envelope: Envelope) -> Any:
        """Deserialize at the receiver half (one transfer onto ``device``),
        decoding through the codec when there is one; timed by the span
        ``learner.recv``."""
        with tracing.Span("learner.recv", bytes=int(envelope.buffer.nbytes)) as span:
            params = packing.unpack_bytes(envelope.buffer, envelope.manifest, self.device)
            if self.codec is not None:
                params = self.codec.decode(params)
            self._account_copy(span, envelope.buffer)
        with self._stats_lock:
            self._c["deserialize_s"].add(span.seconds)
        return params

    # -- upload half (learner -> controller) --------------------------------
    def _resolve_upload_codec(self, envelope: UploadEnvelope) -> Any:
        own = self.upload_codec
        if envelope.codec == own.codec_id and envelope.codec_params == _codec_params(own):
            return own
        try:
            cls = UPLOAD_CODECS[envelope.codec]
        except KeyError:
            raise ValueError(
                f"cannot decode upload codec {envelope.codec!r}; "
                f"known: {sorted(UPLOAD_CODECS)}"
            ) from None
        return cls(**envelope.codec_params)

    def upload(
        self, buffer: torch.Tensor, metadata: dict | None = None, codec: Any = None
    ) -> UploadEnvelope:
        """Learner half of the uplink: encode one flat ``(P,)`` update buffer.

        Accounting is envelope-exact: ``upload_bytes`` counts the payload,
        ``upload_meta_bytes`` the serialized header; wire time covers both.
        The encode is timed by the span ``learner.encode``.
        """
        c = self.upload_codec if codec is None else get_upload_codec(codec)
        n = int(buffer.shape[0])
        with tracing.Span("learner.encode") as span:
            payload = c.encode(buffer)
            span.fields["bytes"] = int(payload.nbytes)
            self._account_copy(span, payload)
        payload.flags.writeable = False  # wire bytes are immutable
        envelope = UploadEnvelope(
            codec=c.codec_id, payload=payload, num_elements=n,
            metadata=dict(metadata or {}), codec_params=_codec_params(c),
        )
        nbytes = int(payload.nbytes)
        meta_nbytes = envelope.meta_nbytes
        with self._stats_lock:
            self._c["upload_serializations"].add(1)
            self._c["upload_serialize_s"].add(span.seconds)
            self._c["upload_messages"].add(1)
            self._c["upload_bytes"].add(nbytes)
            self._c["upload_meta_bytes"].add(meta_nbytes)
            self._c["upload_virtual_wire_s"].add(
                self._wire_time(nbytes + meta_nbytes, (metadata or {}).get("learner_id"))
            )
        return envelope

    def recv_upload(
        self, envelope: UploadEnvelope, with_norm: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """Controller half of the uplink: decode wire bytes to a device row.

        With ``with_norm=True`` returns ``(row, norm)``, the norm an unread
        device scalar enqueued behind the decode (the admission screen's
        single readback).  Timed by the span ``controller.decode``, as the
        quantized and sparse landings below are.
        """
        c = self._resolve_upload_codec(envelope)
        with self._timed_decode(envelope):
            if with_norm:
                fused = getattr(c, "decode_with_norm", None)
                if fused is not None:
                    row, norm = fused(envelope.payload, envelope.num_elements, self.device)
                else:
                    row = c.decode(envelope.payload, envelope.num_elements, self.device)
                    norm = torch.linalg.vector_norm(row.to(torch.float32))
            else:
                row = c.decode(envelope.payload, envelope.num_elements, self.device)
        return (row, norm) if with_norm else row

    @contextlib.contextmanager
    def _timed_decode(self, envelope: UploadEnvelope) -> Iterator[None]:
        """An uplink decode: its span's seconds are ``upload_deserialize_s``."""
        with tracing.Span("controller.decode", bytes=int(envelope.payload.nbytes)) as span:
            yield
            self._account_copy(span, envelope.payload)
        with self._stats_lock:
            self._c["upload_deserialize_s"].add(span.seconds)

    def recv_upload_quantized(
        self, envelope: UploadEnvelope, out_params: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode an int8 upload straight into arena-resident quantized form.

        Returns ``(q int8 (out_params,), scales f32 (out_params//group,),
        norm)``: one host-to-device transfer and a device-side split, with no
        f32 ``(P,)`` row and the admission norm as a device scalar.  Only for
        envelopes whose codec lands quantized rows; accounted as upload
        deserialization work like :meth:`recv_upload`.
        """
        c = self._resolve_upload_codec(envelope)
        decode_q = getattr(c, "decode_quantized", None)
        if decode_q is None:
            raise ValueError(
                f"codec {envelope.codec!r} cannot land quantized rows; "
                "use recv_upload for f32 decode"
            )
        with self._timed_decode(envelope):
            q, scales, norm = decode_q(envelope.payload, envelope.num_elements, out_params,
                                       self.device)
        return q, scales, norm

    def recv_upload_sparse(
        self, envelope: UploadEnvelope
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode a topk upload in sparse form — densification never happens.

        Returns ``(indices int32 (k,), values f32 (k,), norm)`` on
        :attr:`device`: one host-to-device transfer and a device-side split,
        the admission norm a device scalar (top-k indices are unique, so the
        sparse L2 equals the dense row's norm).  Only for envelopes whose codec
        declares ``decode_sparse``; accounted as upload deserialization work
        like :meth:`recv_upload`.
        """
        c = self._resolve_upload_codec(envelope)
        decode_s = getattr(c, "decode_sparse", None)
        if decode_s is None:
            raise ValueError(
                f"codec {envelope.codec!r} cannot land sparse rows; "
                "use recv_upload for dense decode"
            )
        with self._timed_decode(envelope):
            idx, val, norm = decode_s(envelope.payload, envelope.num_elements, self.device)
        return idx, val, norm
