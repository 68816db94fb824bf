"""Simulated transport layer with measured (de)serialization and byte counts.

The port of the raw and int8 halves of ``repro/core/transport.py``.  The
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
  arena, straight into quantized form (:meth:`Channel.recv_upload_quantized`).

The wire stays host bytes (numpy) exactly as in the reference, so uplink and
downlink byte counts equal the reference's for the same run.  The ``topk``
codec is a later slice of the port.  All stats mutation is lock-guarded:
learners upload concurrently from executor threads.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.metrics import Telemetry
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as quant

__all__ = [
    "ChannelStats", "Channel", "Envelope", "Broadcast",
    "UploadEnvelope", "RawUploadCodec", "Int8UploadCodec", "UPLOAD_CODECS",
    "get_upload_codec",
]


#: The channel's telemetry counter names (registered as ``channel.<field>``).
_STAT_FIELDS = (
    "messages", "bytes_moved", "serializations", "serialize_s",
    "deserialize_s", "virtual_wire_s", "upload_messages", "upload_bytes",
    "upload_meta_bytes", "upload_serializations", "upload_serialize_s",
    "upload_deserialize_s", "upload_virtual_wire_s",
)

#: Codecs of the reference that later slices of the port bring.
_LATER_CODECS = {"topk": "slice F"}


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


for _field in _STAT_FIELDS:
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
        return quant.wire_prefix(q, scales, n_scales).cpu().numpy()

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


UPLOAD_CODECS = {"raw": RawUploadCodec, "int8": Int8UploadCodec}


def _codec_params(codec: Any) -> dict:
    """The codec's self-describing wire parameters ({} if it declares none)."""
    wire_params = getattr(codec, "wire_params", None)
    return wire_params() if wire_params is not None else {}


def get_upload_codec(spec: Any) -> Any:
    """Resolve an upload codec: a registry id, a codec object, or ``None`` (raw).

    ``"topk"`` is the reference's other codec; it raises
    ``NotImplementedError`` until its slice of the port lands.
    """
    if spec is None:
        return RawUploadCodec()
    if isinstance(spec, str):
        if spec in _LATER_CODECS:
            raise NotImplementedError(
                f"upload codec {spec!r} is not ported yet "
                f"({_LATER_CODECS[spec]} of the port, ROADMAP.md)"
            )
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

    def _account_serialize(self, dt: float) -> None:
        with self._stats_lock:
            self._c["serializations"].add(1)
            self._c["serialize_s"].add(dt)

    # -- send halves --------------------------------------------------------
    def send(self, params: Any, metadata: dict | None = None) -> Envelope:
        """Serialize a tree for one recipient (the per-send half)."""
        t0 = time.perf_counter()
        if self.codec is not None:
            params = self.codec.encode(params)
        buf, manifest = packing.pack_bytes(params)
        self._account_serialize(time.perf_counter() - t0)
        self._account_send(int(buf.nbytes))
        return Envelope(buffer=buf, manifest=manifest, metadata=dict(metadata or {}))

    def broadcast(
        self,
        params: Any = None,
        metadata: dict | None = None,
        *,
        buffer: torch.Tensor | None = None,
        manifest: packing.Manifest | None = None,
    ) -> Broadcast:
        """Serialize **once** for a fan-out; recipients pay only wire time.

        With ``buffer=``/``manifest=`` (the controller's flat ``global_buffer``
        and its cached manifest) and no codec, the wire bytes come straight off
        the flat buffer; otherwise ``pack_bytes`` of ``params``, encoded by the
        codec when there is one.
        """
        t0 = time.perf_counter()
        if buffer is not None and manifest is not None and self.codec is None:
            wire, m = packing.pack_bytes_from_numeric(buffer, manifest), manifest
        else:
            src = params if self.codec is None else self.codec.encode(params)
            wire, m = packing.pack_bytes(src)
        self._account_serialize(time.perf_counter() - t0)
        return Broadcast(self, wire, m, dict(metadata or {}))

    # -- receive ------------------------------------------------------------
    def recv(self, envelope: Envelope) -> Any:
        """Deserialize at the receiver half (one transfer onto ``device``),
        decoding through the codec when there is one."""
        t0 = time.perf_counter()
        params = packing.unpack_bytes(envelope.buffer, envelope.manifest, self.device)
        if self.codec is not None:
            params = self.codec.decode(params)
        with self._stats_lock:
            self._c["deserialize_s"].add(time.perf_counter() - t0)
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
        """
        c = self.upload_codec if codec is None else get_upload_codec(codec)
        n = int(buffer.shape[0])
        t0 = time.perf_counter()
        payload = c.encode(buffer)
        dt = time.perf_counter() - t0
        payload.flags.writeable = False  # wire bytes are immutable
        envelope = UploadEnvelope(
            codec=c.codec_id, payload=payload, num_elements=n,
            metadata=dict(metadata or {}), codec_params=_codec_params(c),
        )
        nbytes = int(payload.nbytes)
        meta_nbytes = envelope.meta_nbytes
        with self._stats_lock:
            self._c["upload_serializations"].add(1)
            self._c["upload_serialize_s"].add(dt)
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
        single readback).
        """
        c = self._resolve_upload_codec(envelope)
        t0 = time.perf_counter()
        if with_norm:
            fused = getattr(c, "decode_with_norm", None)
            if fused is not None:
                row, norm = fused(envelope.payload, envelope.num_elements, self.device)
            else:
                row = c.decode(envelope.payload, envelope.num_elements, self.device)
                norm = torch.linalg.vector_norm(row.to(torch.float32))
        else:
            row = c.decode(envelope.payload, envelope.num_elements, self.device)
        with self._stats_lock:
            self._c["upload_deserialize_s"].add(time.perf_counter() - t0)
        return (row, norm) if with_norm else row

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
        t0 = time.perf_counter()
        q, scales, norm = decode_q(envelope.payload, envelope.num_elements, out_params,
                                   self.device)
        with self._stats_lock:
            self._c["upload_deserialize_s"].add(time.perf_counter() - t0)
        return q, scales, norm
