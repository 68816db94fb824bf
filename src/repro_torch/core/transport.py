"""Simulated transport layer with measured (de)serialization and byte counts.

The port of the raw half of ``repro/core/transport.py``.  The transport is an
in-process channel that does the *real* serialization work, counts bytes and
accounts virtual wire time from a bandwidth/latency model, without sleeping.
It is full duplex:

* :meth:`Channel.broadcast` — the downlink fan-out: serialize **once** into a
  shared read-only byte buffer (straight off the controller's flat
  ``global_buffer``), then stamp per-recipient envelopes with
  :meth:`Broadcast.to`, each charging that recipient's bytes and wire time;
* :meth:`Channel.upload` / :meth:`Channel.recv_upload` — the uplink: a
  learner's flat ``(P,)`` row is encoded by the ``raw`` codec (f32 bytes) into
  an :class:`UploadEnvelope`; the controller decodes it with one host-to-device
  transfer into a row ready for the arena.

The wire stays host bytes (numpy) exactly as in the reference, so uplink and
downlink byte counts equal the reference's for the same run.  The ``int8`` and
``topk`` codecs are later slices of the port.  All stats mutation is
lock-guarded: learners upload concurrently from executor threads.
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

__all__ = [
    "ChannelStats", "Channel", "Envelope", "Broadcast",
    "UploadEnvelope", "RawUploadCodec", "UPLOAD_CODECS", "get_upload_codec",
]


#: The channel's telemetry counter names (registered as ``channel.<field>``).
_STAT_FIELDS = (
    "messages", "bytes_moved", "serializations", "serialize_s",
    "deserialize_s", "virtual_wire_s", "upload_messages", "upload_bytes",
    "upload_meta_bytes", "upload_serializations", "upload_serialize_s",
    "upload_deserialize_s", "upload_virtual_wire_s",
)

#: Codecs of the reference that later slices of the port bring.
_LATER_CODECS = {"int8": "slice C", "topk": "slice F"}


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


UPLOAD_CODECS = {"raw": RawUploadCodec}


def _codec_params(codec: Any) -> dict:
    """The codec's self-describing wire parameters ({} if it declares none)."""
    wire_params = getattr(codec, "wire_params", None)
    return wire_params() if wire_params is not None else {}


def get_upload_codec(spec: Any) -> Any:
    """Resolve an upload codec: a registry id, a codec object, or ``None`` (raw).

    ``"int8"`` and ``"topk"`` are the reference's other codecs; they raise
    ``NotImplementedError`` until their slice of the port lands.
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
    never block.  ``upload_codec`` selects the uplink wire format (``"raw"``).
    ``device`` is where received tensors land (downlink models and decoded
    upload rows).  All wire accounting lives as ``channel.*`` counters in
    ``telemetry``; ``stats`` is the :class:`ChannelStats` read view.
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
        if quantize_codec is not None:
            raise NotImplementedError(
                "the int8 downlink codec is slice C of the port (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.bandwidth_gbps = bandwidth_gbps
        self.latency_ms = latency_ms
        self.learner_bandwidth_gbps: dict[str, float] = {}
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
        and its cached manifest) the wire bytes come straight off the flat
        buffer; otherwise ``pack_bytes(params)``.
        """
        t0 = time.perf_counter()
        if buffer is not None and manifest is not None:
            wire, m = packing.pack_bytes_from_numeric(buffer, manifest), manifest
        else:
            wire, m = packing.pack_bytes(params)
        self._account_serialize(time.perf_counter() - t0)
        return Broadcast(self, wire, m, dict(metadata or {}))

    # -- receive ------------------------------------------------------------
    def recv(self, envelope: Envelope) -> Any:
        """Deserialize at the receiver half (one transfer onto ``device``)."""
        t0 = time.perf_counter()
        params = packing.unpack_bytes(envelope.buffer, envelope.manifest, self.device)
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
