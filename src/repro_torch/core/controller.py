"""The Federation Controller — model state, transport and store plumbing.

The port of ``repro/core/controller.py`` for the ported slices: every
protocol policy (round-based and continuous), the f32, int8 or sparse
(top-k) arena, one-device or column-sharded over a slot mesh, or the stack
store, the raw, int8 or top-k upload codec (and
the int8 downlink codec), FedAvg and the robust rules.  The round engine
(``core/engine.py``) drives protocols and calls back into this plumbing:

* **serialize-once broadcast** — the global model is serialized at most once
  per model version (:meth:`Controller._broadcast`), straight off the flat
  ``global_buffer``;
* **measured upload ingest** (:meth:`Controller.ingest`) — learners send
  packed rows through the measured uplink; arrival is a decode, the
  admission screen on the row's L2 norm, and an in-place arena row write.
  An int8 upload into an int8 arena lands directly, still quantized, and a
  top-k upload into the sparse arena (``sparse_mode="direct"``) as its
  ``(index, value)`` stream;
* **aggregation** (:meth:`Controller.aggregate_round`) — one masked FedAvg
  over the ``(n_max, P)`` arena, which on the card is a hand-written Hopper
  kernel (the fused dequant-into-aggregate on an int8 arena); or, under
  ``aggregation_rule="trimmed_mean"`` / ``"median"``, the robust order
  statistic (the trimmed mean through the hand-written sorting-network kernel,
  the median through ``torch.sort``); over the sparse arena, a masked
  scatter-accumulate (``torch.index_add_`` row by row); then the server
  optimizer, a wait on the device and the commit.  Top-k uploads carry
  *deltas*, so the commit adds the aggregate onto the global model first;
* **community updates** (:meth:`Controller.aggregate_community`,
  :meth:`Controller.aggregate_buffer`) — the continuous policies'
  staleness-damped reduce over every valid row (async) or exactly the
  buffered members (FedBuff), through the same kernels with staleness
  weights;
* **secure aggregation** (``secure=True``, ``core/secure.py``) — every
  aggregate instead sums mask-encoded int32 fixed-point rows inside a
  per-epoch :class:`~repro_torch.core.secure.MaskSession` (the round id, or
  the model version on the continuous path), so the controller never sees a
  single model; admission control is off there;
* **checkpoints** (:meth:`Controller.save_checkpoint`,
  :meth:`Controller.restore`) — the whole federation state in one ``.npz``
  (``repro_torch.checkpoint``), written by the engine every
  ``checkpoint_every`` rounds after it drains the tasks in flight.

With ``arena_mesh=`` the arena is column-sharded over a slot mesh
(``launch/mesh.make_controller_mesh``) and every reduction above runs once
per slot on the slot's shard (``core/aggregation.*_sharded``), with the
result assembled on the controller's device.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import aggregation, packing, tracing
from repro_torch.core import secure as secure_mod
from repro_torch.core.engine import RoundEngine, RoundTimings, UploadRejectedError
from repro_torch.core.journal import EventJournal, jsonable
from repro_torch.core.learner import Learner, LocalUpdate
from repro_torch.core.metrics import Telemetry
from repro_torch.core.scheduler import LearnerProfile, ProtocolPolicy, SyncProtocol
from repro_torch.core.selection import SelectionPolicy
from repro_torch.core.server_opt import ServerOptimizer, make_server_optimizer
from repro_torch.core.store import ArenaStore, ModelRecord, ModelStore
from repro_torch.core.transport import Broadcast, Channel, get_upload_codec
from repro_torch.device import resolve_device, wait_queued
from repro_torch.tree import flatten, unflatten

__all__ = ["RoundTimings", "Controller"]


AggregateFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Controller:
    """The federation controller: model state + transport + store plumbing.

    ``controller.engine.run(rounds=N)`` drives a round-based protocol,
    ``controller.engine.run(total_updates=N)`` a continuous one.  Parameters
    follow the reference's ``Controller``; this slice honours:

    protocol:
        A :class:`~repro_torch.core.scheduler.ProtocolPolicy`
        (``SyncProtocol`` by default).
    aggregate_fn / masked_aggregate_fn:
        ``(stack, weights) -> (P,)`` and ``(arena, weights, mask) -> (P,)``;
        default to FedAvg through ``kernels/ops`` (the Hopper kernel on CUDA).
    secure / secure_seed:
        Sum mask-encoded fixed-point uploads (``core/secure``) in a fresh
        mask session per round id (or, on the continuous path, per global
        model version), keyed by ``secure_seed``.  Forces admission control
        off: the norms of masked rows mean nothing.
    aggregation_rule / trim_k:
        ``"fedavg"``, ``"median"`` or ``"trimmed_mean"`` (dropping ``trim_k``
        extremes per side and coordinate); the robust rules replace a custom
        aggregate function and refuse secure aggregation and
        staleness-weighted or buffer-scoped protocols, as in the reference.
    store_mode:
        ``"arena"`` (default) aggregates straight off the device-resident
        :class:`ArenaStore`; ``"stack"`` re-stacks the hash-map store.
    arena_mesh / arena_axes:
        A slot mesh (``launch/mesh.make_controller_mesh``) and the axes to
        shard the arena's columns over (default its ``"data"`` axis): the
        arena is then column-sharded, one shard a slot, and the reduce, the
        staleness update and the secure sum run once per slot.  Arena mode
        only.  A custom masked rule gets the shards assembled into one
        ``(n_max, P)`` tensor on ``device``.
    arena_dtype:
        ``"f32"`` or ``"int8"`` (the quantized-resident arena: FedAvg only,
        arena store only, no custom aggregate function).
    flat_uploads / upload_codec:
        Ship the manifest at registration so learners upload packed rows
        through the measured uplink; ``"raw"``, ``"int8"``, ``"topk"`` or a
        codec object such as ``TopkUploadCodec(k=...)``.
    sparse_mode:
        How a top-k upload lands: ``"densify"`` scatters it into a dense row
        (every store and rule keeps working), ``"direct"`` keeps an
        ``(n_max, k)`` index/value arena and reduces it by a masked
        scatter-accumulate (FedAvg and staleness weights, f32 arena only).
    admission_control and its knobs, quarantine_threshold / quarantine_decay:
        The upload admission screen (reject non-finite rows, clip norm
        outliers against an EWMA) and quarantine of repeat offenders, on by
        default as in the reference.
    checkpoint_every / checkpoint_dir:
        Every ``checkpoint_every`` completed rounds the engine drains the
        tasks in flight and calls :meth:`save_checkpoint` into
        ``checkpoint_dir``; :meth:`restore` resumes a fresh controller from
        it.  Both default to off; ``engine.run(checkpoint_every=...,
        checkpoint_dir=...)`` overrides them per run.
    device:
        Where the global model, the arena and decoded uploads live; the
        card unless ``device="cpu"``.

    All wire/store/dispatch counters live in one
    :class:`~repro_torch.core.metrics.Telemetry` registry at
    :attr:`telemetry`, under the reference's names.
    """

    def __init__(
        self,
        protocol: ProtocolPolicy | None = None,
        selection: SelectionPolicy | None = None,
        aggregate_fn: AggregateFn | None = None,
        server_optimizer: ServerOptimizer | None = None,
        store: ModelStore | None = None,
        channel: Channel | None = None,
        secure: bool = False,
        max_dispatch_workers: int = 32,
        secure_seed: int = 0,
        store_mode: str = "arena",
        masked_aggregate_fn: Callable | None = None,
        arena_n_max: int = 8,
        arena_row_align: int = 1024,
        arena_mesh: Any = None,
        arena_axes: Any = None,
        arena_dtype: str = "f32",
        sparse_mode: str = "densify",
        flat_uploads: bool = True,
        upload_codec: Any = None,
        profile_decay: float = 0.5,
        journal: EventJournal | None = None,
        journal_sink: Any = None,
        journal_capacity: int = 4096,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None,
        aggregation_rule: str = "fedavg",
        trim_k: int = 1,
        admission_control: bool = True,
        admission_clip_factor: float = 4.0,
        admission_ewma_decay: float = 0.9,
        admission_warmup: int = 8,
        quarantine_threshold: float = 2.0,
        quarantine_decay: float = 0.75,
        device: str | torch.device | None = None,
    ):
        if store_mode not in ("arena", "stack"):
            raise ValueError(f"store_mode must be 'arena' or 'stack', got {store_mode!r}")
        if arena_dtype not in ("f32", "int8"):
            raise ValueError(f"arena_dtype must be 'f32' or 'int8', got {arena_dtype!r}")
        if arena_dtype == "int8":
            # The quantized arena supports exactly the weighted-average family
            # (fused dequant-into-aggregate); everything that needs f32 rows
            # refuses instead of widening the resident state back to f32.
            if store_mode != "arena":
                raise ValueError(
                    "arena_dtype='int8' requires store_mode='arena'; the "
                    "stack store keeps decoded f32 buffers"
                )
            if secure:
                raise ValueError(
                    "arena_dtype='int8' cannot run under secure "
                    "aggregation: mask-encoded fixed-point rows are f32-only"
                )
            if aggregation_rule != "fedavg":
                raise ValueError(
                    f"aggregation_rule={aggregation_rule!r} is f32-only: "
                    "order statistics sort full-precision rows and have no "
                    "fused dequantized form.  Use arena_dtype='f32' for "
                    "robust rules — see the support matrix in docs/ARENA.md"
                )
            if aggregate_fn is not None or masked_aggregate_fn is not None:
                raise ValueError(
                    "arena_dtype='int8' cannot honour a custom aggregate_fn/"
                    "masked_aggregate_fn: custom rules expect an f32 arena "
                    "buffer, not int8 values + scales"
                )
        self.arena_dtype = arena_dtype
        self.arena_mesh = arena_mesh
        self.arena_axes = arena_axes
        if arena_mesh is not None and store_mode != "arena":
            raise ValueError("arena_mesh= requires store_mode='arena'")
        # The rule-matched sharded reductions, built in set_initial_model when
        # the arena is sharded.
        self._sharded_masked_fn: Callable | None = None
        self._sharded_staleness_fn: Callable | None = None
        self._sharded_q8_fn: Callable | None = None
        self._sharded_staleness_q8_fn: Callable | None = None
        self._sharded_topk_fn: Callable | None = None
        self._sharded_staleness_topk_fn: Callable | None = None
        if store is not None and store_mode == "arena":
            raise ValueError(
                "store= is only honoured with store_mode='stack'; the arena "
                "mode keeps uploads in its device-resident ArenaStore"
            )
        self.protocol = protocol or SyncProtocol()
        self.device = resolve_device(device)
        self.selection = selection or SelectionPolicy()
        if aggregation_rule not in ("fedavg", "median", "trimmed_mean"):
            raise ValueError(
                "aggregation_rule must be 'fedavg', 'median' or "
                f"'trimmed_mean', got {aggregation_rule!r}"
            )
        if not isinstance(trim_k, int) or trim_k < 1:
            raise ValueError(f"trim_k must be an int >= 1, got {trim_k!r}")
        self.aggregation_rule = aggregation_rule
        self.trim_k = int(trim_k)
        if aggregation_rule != "fedavg":
            # Robust rules are order statistics: they have no secure-sum
            # form, no staleness-weighted form, and they replace (rather
            # than compose with) a custom aggregate function.
            if aggregate_fn is not None or masked_aggregate_fn is not None:
                raise ValueError(
                    "aggregation_rule= and a custom aggregate_fn/"
                    "masked_aggregate_fn are mutually exclusive"
                )
            if secure:
                raise ValueError(
                    f"aggregation_rule={aggregation_rule!r} cannot run under "
                    "secure aggregation: the controller only ever sees a "
                    "masked sum, and order statistics need the rows"
                )
            if (self.protocol.weighting() == "staleness"
                    or getattr(self.protocol, "aggregate_scope", None) == "buffer"):
                raise ValueError(
                    f"aggregation_rule={aggregation_rule!r} is not defined "
                    "for staleness-weighted protocols (async / FedBuff): "
                    "the staleness discount has no order-statistic "
                    "analogue.  Use aggregation_rule='fedavg' there — see "
                    "the support matrix in docs/PROTOCOLS.md"
                )
        # A custom masked rule (or the wrapped custom aggregate_fn) opts out
        # of the rule-matched sharded reduction built in set_initial_model.
        self._masked_is_default = aggregate_fn is None and masked_aggregate_fn is None
        if aggregation_rule == "median":
            self.aggregate_fn = lambda stack, w: aggregation.coordinate_median(stack)
            self.masked_aggregate_fn = aggregation.masked_coordinate_median
        elif aggregation_rule == "trimmed_mean":
            tk = self.trim_k
            self.aggregate_fn = lambda stack, w: aggregation.trimmed_mean(stack, tk)
            self.masked_aggregate_fn = (
                lambda arena, w, m: aggregation.masked_trimmed_mean(arena, w, m, tk)
            )
        elif masked_aggregate_fn is not None:
            self.aggregate_fn = aggregate_fn or aggregation.fedavg
            self.masked_aggregate_fn = masked_aggregate_fn
        elif aggregate_fn is not None:
            self.aggregate_fn = aggregate_fn
            self.masked_aggregate_fn = lambda arena, w, m: aggregate_fn(arena, w * m)
        else:
            self.aggregate_fn = aggregation.fedavg
            self.masked_aggregate_fn = aggregation.masked_weighted_average
        self.server_opt = server_optimizer or make_server_optimizer("fedavg")
        self.store = store or ModelStore()
        self.store_mode = store_mode
        self.arena: ArenaStore | None = None
        self._arena_n_max = arena_n_max
        self._arena_row_align = arena_row_align
        self.channel = channel or Channel(device=self.device)
        if self.channel.device != self.device:
            raise ValueError(
                f"the channel decodes onto {self.channel.device}, the controller "
                f"runs on {self.device}"
            )
        if upload_codec is not None:
            self.channel.upload_codec = get_upload_codec(upload_codec)
        # Sparse (top-k) uplink: rows hold deltas, so every aggregate commits
        # global_buffer + aggregated delta; sparse_mode picks how an upload
        # lands (see the class docstring).
        self._topk = getattr(self.channel.upload_codec, "codec_id", None) == "topk"
        if sparse_mode not in ("direct", "densify"):
            raise ValueError(
                f"sparse_mode must be 'direct' or 'densify', got {sparse_mode!r}"
            )
        self.sparse_mode = sparse_mode
        if self._topk:
            if secure:
                raise ValueError(
                    "upload_codec='topk' cannot run under secure "
                    "aggregation: the controller must densify and re-weight "
                    "sparse deltas, and the masked fixed-point rows admit "
                    "neither"
                )
            if not flat_uploads:
                raise ValueError(
                    "upload_codec='topk' requires flat_uploads=True: the "
                    "error-feedback residual lives learner-side against "
                    "the shipped wire manifest"
                )
            if aggregate_fn is not None or masked_aggregate_fn is not None:
                raise ValueError(
                    "upload_codec='topk' cannot honour a custom "
                    "aggregate_fn/masked_aggregate_fn: sparse rows hold "
                    "deltas, and custom rules expect full-parameter rows"
                )
        if sparse_mode == "direct":
            if not self._topk:
                raise ValueError("sparse_mode='direct' requires upload_codec='topk'")
            if store_mode != "arena":
                raise ValueError(
                    "sparse_mode='direct' requires store_mode='arena'; the "
                    "stack store keeps dense decoded buffers"
                )
            if aggregation_rule != "fedavg":
                raise ValueError(
                    "sparse_mode='direct' supports only "
                    "aggregation_rule='fedavg'; the robust order-statistic "
                    "rules need dense rows — use sparse_mode='densify' "
                    f"(got {aggregation_rule!r})"
                )
            if arena_dtype != "f32":
                raise ValueError(
                    "sparse_mode='direct' keeps its own (n, k) sparse "
                    "arena; it cannot combine with "
                    f"arena_dtype={arena_dtype!r}"
                )
        # One observability surface: the controller adopts its channel's registry.
        self.telemetry: Telemetry = self.channel.telemetry
        self.store.bind_telemetry(self.telemetry)
        self.secure = secure
        self.secure_seed = secure_seed
        self.profile_decay = profile_decay
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        # Admission control: non-finite rows are rejected; once the EWMA of
        # accepted norms has warmed up, outlier norms are clipped to
        # factor * EWMA.  Off under secure aggregation: the controller only
        # ever sees mask-encoded rows there, whose norms mean nothing.
        self.admission_control = bool(admission_control) and not secure
        self.admission_clip_factor = float(admission_clip_factor)
        self.admission_ewma_decay = float(admission_ewma_decay)
        self.admission_warmup = int(admission_warmup)
        self._adm_ewma: float | None = None
        self._adm_accepted = 0
        # Quarantine: per-learner decaying offense score; entered at
        # score >= threshold, released below threshold / 2 (hysteresis).
        self.quarantine_threshold = float(quarantine_threshold)
        self.quarantine_decay = float(quarantine_decay)
        self._offenses: dict[str, tuple[float, int]] = {}
        self._quarantined: set[str] = set()

        self._learners: dict[str, Learner] = {}
        self._learner_profiles: dict[str, LearnerProfile] = {}
        self._deregistered_at: dict[str, int] = {}
        self._c_dropouts = self.telemetry.counter("engine.faults.dropouts")
        self._c_rejoins = self.telemetry.counter("engine.faults.rejoins")
        self._c_rejected_nonfinite = self.telemetry.counter("engine.uploads.rejected.nonfinite")
        self._c_clipped = self.telemetry.counter("engine.uploads.clipped")
        # Quantized-arena fast paths: uploads landed in int8 form with no f32
        # row, and fused dequant-into-aggregate reductions.
        self._c_quant_direct = self.telemetry.counter("engine.uploads.quantized_direct")
        self._c_fused_agg = self.telemetry.counter("controller.aggregations.fused_q8")
        # Sparse-uplink fast paths: uploads landed in the (n, k) sparse arena
        # with no densification, and masked scatter-accumulate reductions.
        self._c_sparse_direct = self.telemetry.counter("engine.uploads.sparse_direct")
        self._c_sparse_agg = self.telemetry.counter("controller.aggregations.sparse_scatter")
        self._c_quarantined = self.telemetry.counter("engine.quarantine.entered")
        self._g_quarantine = self.telemetry.gauge("engine.quarantine.active")
        self._store_lock = threading.Lock()

        self.global_params: Any = None
        self.global_buffer: torch.Tensor | None = None
        self.manifest: packing.Manifest | None = None
        self._server_state = None
        self.round_id = 0
        self.history: list[RoundTimings] = []
        self._model_version = 0
        self._learner_versions: dict[str, int] = {}
        self.flat_uploads = flat_uploads
        self._wire_lock = threading.Lock()
        self._wire_cache: tuple[tuple[int, int], Broadcast] | None = None
        self._c_dispatch_ser = self.telemetry.counter("controller.dispatch_serializations")
        self._c_fallback = self.telemetry.counter("controller.upload_fallback_packs")
        self._g_version = self.telemetry.gauge("controller.model_version")
        if journal is None:
            journal = EventJournal(capacity=journal_capacity, sink=journal_sink)
        self.engine = RoundEngine(self, max_dispatch_workers=max_dispatch_workers,
                                  journal=journal)

    @property
    def dispatch_serializations(self) -> int:
        """Shim for ``telemetry.value('controller.dispatch_serializations')``."""
        return self._c_dispatch_ser.value

    @property
    def upload_fallback_packs(self) -> int:
        """Shim for ``telemetry.value('controller.upload_fallback_packs')``."""
        return self._c_fallback.value

    @property
    def journal(self) -> EventJournal:
        """The engine's flight recorder (``core/journal.EventJournal``)."""
        return self.engine.journal

    # ------------------------------------------------------------------ init
    def set_initial_model(self, params: Any) -> None:
        """Driver ships initial model tensors to the controller (Fig. 8).

        The canonical state is the flat f32 ``global_buffer`` on the
        controller's device plus the cached ``manifest``; ``global_params``
        is normalized through one numeric round trip.
        """
        self.manifest = packing.build_manifest(params)
        self.global_buffer = packing.pack_numeric(params).to(self.device)
        self.global_params = packing.unpack_numeric(self.global_buffer, self.manifest)
        self._server_state = self.server_opt.init(self.global_buffer)
        self.invalidate_wire_cache()
        if self.store_mode == "arena":
            direct = self._topk and self.sparse_mode == "direct"
            self.arena = ArenaStore(
                num_params=max(1, int(self.global_buffer.shape[0])),
                n_max=max(self._arena_n_max, len(self._learners)),
                row_align=self._arena_row_align,
                mesh=self.arena_mesh,
                axes=self.arena_axes,
                telemetry=self.telemetry,
                arena_dtype="topk" if direct else self.arena_dtype,
                sparse_k=self.channel.upload_codec.k if direct else None,
                device=self.device,
            )
            # Rows follow registration order, so aggregation order is
            # reproducible.
            for lid in self._learners:
                self.arena.ensure_row(lid)
            if self.aggregation_rule == "trimmed_mean" and 2 * self.trim_k >= self.arena.n_max:
                raise ValueError(
                    f"trim_k={self.trim_k} trims 2*trim_k={2 * self.trim_k} "
                    f"rows but the arena only holds {self.arena.n_max}; "
                    "every cohort would fall back to the untrimmed mean"
                )
            if self.arena.sharded:
                self._build_sharded_reductions()
        for learner in self._learners.values():
            self._ship_manifest(learner)

    def _build_sharded_reductions(self) -> None:
        """The per-slot reductions matched to the arena and the rule.

        Every rule is per column, so each shards the same way: the sparse
        arena's scatter (whole ``(n, k)`` inputs, windowed output), the int8
        arena's fused reduce, and on the f32 arena the configured rule's.  A
        custom masked rule is honoured as it is, on the assembled buffer.
        """
        arena = self.arena
        mesh, axes = arena.mesh, arena.axes
        alpha = getattr(self.protocol, "staleness_alpha", 0.5)
        if arena.arena_dtype == "topk":
            self._sharded_topk_fn = aggregation.masked_fedavg_topk_sharded(
                mesh, axes, arena.padded_params)
            self._sharded_staleness_topk_fn = aggregation.masked_staleness_topk_sharded(
                mesh, axes, arena.padded_params, alpha)
            return
        if self.arena_dtype == "int8":
            self._sharded_q8_fn = aggregation.masked_fedavg_q8_sharded(
                mesh, axes, arena.qgroup)
            self._sharded_staleness_q8_fn = aggregation.masked_staleness_q8_sharded(
                mesh, axes, alpha, arena.qgroup)
            return
        if self._masked_is_default:
            if self.aggregation_rule == "median":
                self._sharded_masked_fn = aggregation.masked_median_sharded(mesh, axes)
            elif self.aggregation_rule == "trimmed_mean":
                self._sharded_masked_fn = aggregation.masked_trimmed_mean_sharded(
                    mesh, axes, self.trim_k)
            else:
                self._sharded_masked_fn = aggregation.masked_fedavg_sharded(mesh, axes)
        self._sharded_staleness_fn = aggregation.masked_staleness_sharded(mesh, axes, alpha)

    def _ship_manifest(self, learner: Learner) -> None:
        """Ship the wire contract (manifest + row width + channel) once."""
        if not self.flat_uploads or self.manifest is None:
            return
        pad_to = self.arena.padded_params if self.arena is not None else None
        learner.accept_manifest(self.manifest, pad_to=pad_to, channel=self.channel)

    def register_learner(self, learner: Learner) -> None:
        """Admit a learner to the federation (paper Fig. 8 join).

        Call only while the engine loop is idle (between ``engine.run``
        calls) or from the loop thread.
        """
        lid = learner.learner_id
        rejoining = lid in self._deregistered_at
        self._learners[lid] = learner
        prof = self._learner_profiles.get(lid)
        if prof is None:
            self._learner_profiles[lid] = LearnerProfile(decay=self.profile_decay)
        elif rejoining:
            prof.decay_reputation(self.round_id - self._deregistered_at[lid])
        if rejoining:
            del self._deregistered_at[lid]
            self._c_rejoins.add(1)
        self._learner_versions[lid] = 0
        if self.arena is not None:
            self.arena.ensure_row(lid)
        self._ship_manifest(learner)

    def deregister_learner(self, learner_id: str) -> None:
        """Remove a learner mid-federation (dropout); unknown ids are a no-op.

        Call only while the engine loop is idle (between ``engine.run``
        calls) or from the loop thread: it mutates the engine's FedBuff
        buffer.
        """
        if learner_id not in self._learners:
            return
        del self._learners[learner_id]
        self._deregistered_at[learner_id] = int(self.round_id)
        if self.arena is not None:
            self.arena.invalidate(learner_id)
        else:
            with self._store_lock:
                self.store.discard(learner_id)
        # A buffered (ingested-but-unaggregated) FedBuff member can no longer
        # contribute: it leaves the pending buffer too.
        if learner_id in self.engine._buffer:
            self.engine._buffer.remove(learner_id)
        self._c_dropouts.add(1)

    @property
    def learner_ids(self) -> list[str]:
        """IDs of every registered learner, in registration order."""
        return list(self._learners)

    # -------------------------------------------------------------- dispatch
    def _broadcast(self) -> Broadcast:
        """The current model's shared wire payload, serialized at most once
        per (model version, downlink codec): bytes straight off
        ``global_buffer``, or the codec's encoding of ``global_params``."""
        key = (self._model_version, id(self.channel.codec))
        with self._wire_lock:
            if self._wire_cache is None or self._wire_cache[0] != key:
                bc = self.channel.broadcast(params=self.global_params,
                                            buffer=self.global_buffer, manifest=self.manifest,
                                            version=self._model_version)
                self._c_dispatch_ser.add(1)
                self._wire_cache = (key, bc)
            return self._wire_cache[1]

    def invalidate_wire_cache(self) -> None:
        """Drop the cached broadcast; the next dispatch serializes anew."""
        with self._wire_lock:
            self._wire_cache = None

    def wire_time_s(self, learner_id: str) -> float:
        """Per-learner round-trip virtual wire estimate: downlink + uplink."""
        if self.manifest is None:
            return 0.0
        down = int(self.manifest.total_bytes)
        prof = self._learner_profiles.get(learner_id)
        up = prof.get("upload_bytes") if prof is not None else None
        if up is None:
            n = (self.arena.padded_params if self.arena is not None
                 else int(self.global_buffer.shape[0]))
            wire_nbytes = getattr(self.channel.upload_codec, "wire_nbytes", None)
            up = wire_nbytes(n) if wire_nbytes is not None else 4 * n
        return self.channel.round_trip_s(down, int(up), learner_id=learner_id)

    # ---------------------------------------------------------------- ingest
    def _upload_buffer(
        self, update: LocalUpdate, pad_to: int | None, with_norm: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """The upload's decoded flat buffer, always off the measured uplink.

        A bare buffer, or a tree the controller must pack itself (counted in
        ``upload_fallback_packs``), crosses the same measured half with the
        controller standing in for the learner's send.
        """
        if update.upload is not None:
            return self.channel.recv_upload(update.upload, with_norm=with_norm)
        buffer = update.buffer
        if buffer is None:
            self._c_fallback.add(1)
            buffer = packing.pack_numeric(update.params, pad_to=pad_to)
        envelope = self.channel.upload(
            buffer, metadata={"learner_id": update.learner_id, "round_id": update.round_id},
        )
        return self.channel.recv_upload(envelope, with_norm=with_norm)

    def _screen_norm(self, learner_id: str, norm: float) -> tuple[float | None, dict | None]:
        """The admission decision on an already-materialized norm.

        Non-finite: reject (:class:`UploadRejectedError`, counted in
        ``engine.uploads.rejected.nonfinite``).  Beyond
        ``admission_clip_factor`` × the EWMA of accepted norms (after
        ``admission_warmup`` uploads): clip (counted in
        ``engine.uploads.clipped``).  Returns ``(scale, clip_info)``.
        """
        if not math.isfinite(norm):
            self._c_rejected_nonfinite.add(1)
            raise UploadRejectedError(learner_id, "nonfinite", norm)
        scale: float | None = None
        clip: dict | None = None
        if self._adm_ewma is not None and self._adm_accepted >= self.admission_warmup:
            limit = self.admission_clip_factor * self._adm_ewma
            if norm > limit > 0.0:
                scale = limit / norm
                self._c_clipped.add(1)
                clip = {"norm": norm, "limit": limit}
                norm = limit
        d = self.admission_ewma_decay
        self._adm_ewma = norm if self._adm_ewma is None else d * self._adm_ewma + (1.0 - d) * norm
        self._adm_accepted += 1
        return scale, clip

    def _screen_upload(
        self, learner_id: str, buffer: torch.Tensor, norm: torch.Tensor
    ) -> tuple[torch.Tensor, dict | None]:
        """The admission screen on the decoded row; one host readback (the norm)."""
        scale, clip = self._screen_norm(learner_id, float(norm))
        if scale is not None:
            buffer = buffer * scale
        return buffer, clip

    def ingest(self, update: LocalUpdate) -> dict | None:
        """MarkTaskCompleted plumbing: decode the upload, screen, store, profile.

        Arena mode decodes the wire row and writes it in place into the
        learner's arena row; stack mode inserts it into the hash-map store.
        An int8 upload matching an int8 arena's layout lands directly
        (:meth:`_quant_direct_ok`): the wire's int8 groups and scales are
        split on the device and copied into the row, with no f32 row and no
        requantization.  Its norm comes from the quantized form and clipping
        rescales the scales.  Counted in ``engine.uploads.quantized_direct``.
        A top-k upload into the sparse arena lands as its ``(index, value)``
        stream (:meth:`_sparse_direct_ok`; the norm is the values' and
        clipping rescales them), counted in ``engine.uploads.sparse_direct``;
        anything else is refused there.  Returns the screen's clip info
        (``None`` when stored untouched).  Timed by the span
        ``controller.ingest``.
        """
        up = update.upload
        with tracing.Span("controller.ingest",
                          bytes=None if up is None else int(up.payload.nbytes)):
            return self._ingest(update)

    def _ingest(self, update: LocalUpdate) -> dict | None:
        version = self._learner_versions.get(update.learner_id, 0)
        if self._sparse_direct_ok(update):
            return self._ingest_sparse(update, version)
        if self.arena is not None and self.arena.arena_dtype == "topk":
            raise ValueError(
                "sparse_mode='direct' arena can only land registry "
                "'topk' envelopes packed at the arena row width; got "
                f"codec={getattr(update.upload, 'codec', None)!r}"
            )
        if self._quant_direct_ok(update):
            return self._ingest_quantized(update, version)
        pad_to = self.arena.padded_params if self.store_mode == "arena" else None
        clip: dict | None = None
        if self.admission_control:
            buffer, norm = self._upload_buffer(update, pad_to=pad_to, with_norm=True)
            buffer, clip = self._screen_upload(update.learner_id, buffer, norm)
        else:
            buffer = self._upload_buffer(update, pad_to=pad_to)
        if self.store_mode == "arena":
            self.arena.write(
                update.learner_id, buffer,
                weight=float(update.num_examples), version=float(version),
            )
        else:
            with self._store_lock:
                self.store.insert(
                    ModelRecord(
                        learner_id=update.learner_id,
                        round_id=update.round_id,
                        buffer=buffer,
                        num_examples=update.num_examples,
                        metadata={
                            **update.metrics,
                            "seconds_per_step": update.seconds_per_step,
                            "model_version": version,
                        },
                    )
                )
        self._observe(update)
        return clip

    def _ingest_quantized(self, update: LocalUpdate, version: int) -> dict | None:
        """The int8 arena's direct landing of an int8 upload."""
        q, scales, norm = self.channel.recv_upload_quantized(
            update.upload, self.arena.padded_params
        )
        clip: dict | None = None
        if self.admission_control:
            scale, clip = self._screen_norm(update.learner_id, float(norm))
            if scale is not None:
                # Clipping a quantized row == rescaling its scales.
                scales = scales * torch.tensor(scale, dtype=torch.float32)
        self.arena.write_quantized(
            update.learner_id, q, scales,
            weight=float(update.num_examples), version=float(version),
        )
        self._c_quant_direct.add(1)
        self._observe(update)
        return clip

    def _ingest_sparse(self, update: LocalUpdate, version: int) -> dict | None:
        """The sparse arena's direct landing of a top-k upload."""
        idx, val, norm = self.channel.recv_upload_sparse(update.upload)
        clip: dict | None = None
        if self.admission_control:
            scale, clip = self._screen_norm(update.learner_id, float(norm))
            if scale is not None:
                # Clipping a sparse row == rescaling its values (top-k indices
                # are unique, so the value vector's norm is the row's).
                val = val * torch.tensor(scale, dtype=torch.float32)
        self.arena.write_sparse(
            update.learner_id, idx, val,
            weight=float(update.num_examples), version=float(version),
        )
        self._c_sparse_direct.add(1)
        self._observe(update)
        return clip

    def _observe(self, update: LocalUpdate) -> None:
        """Feed the learner's profile: step time and upload bytes."""
        prof = self._learner_profiles[update.learner_id]
        prof.observe_step_time(update.seconds_per_step)
        if update.upload is not None:
            prof.observe_upload_bytes(update.upload.payload.nbytes)

    def _sparse_direct_ok(self, update: LocalUpdate) -> bool:
        """True when the upload can land in the ``(n, k)`` sparse arena as-is.

        Requires a ``sparse_mode="direct"`` arena and an envelope of the
        registry ``topk`` codec packed at the arena's padded row width (the
        ``flat_uploads`` fast path).
        """
        if self.arena is None or self.arena.arena_dtype != "topk":
            return False
        env = update.upload
        return (
            env is not None
            and env.codec == "topk"
            and int(env.num_elements) == self.arena.padded_params
        )

    def _quant_direct_ok(self, update: LocalUpdate) -> bool:
        """True when the upload can land in the int8 arena without dequant.

        Requires an int8 arena and an envelope of the registry ``int8`` codec
        whose group matches the arena's ``qgroup``, packed at the arena's
        padded row width (the ``flat_uploads`` fast path).  Anything else
        falls back to the f32 decode, and :meth:`ArenaStore.write` requantizes.
        """
        if self.arena is None or self.arena.arena_dtype != "int8":
            return False
        env = update.upload
        return (
            env is not None
            and env.codec == "int8"
            and int(env.codec_params.get("group", 0)) == self.arena.qgroup
            and int(env.num_elements) == self.arena.padded_params
        )

    # ------------------------------------------------------------ quarantine
    def offense_score(self, learner_id: str) -> float:
        """The learner's offense score, decayed to the current round."""
        entry = self._offenses.get(learner_id)
        if entry is None:
            return 0.0
        score, last_round = entry
        delta = max(int(self.round_id) - int(last_round), 0)
        return score * (self.quarantine_decay ** delta)

    def note_offense(self, learner_id: str) -> bool:
        """Record one admission offense; True when it newly quarantined."""
        score = self.offense_score(learner_id) + 1.0
        self._offenses[learner_id] = (score, int(self.round_id))
        entered = score >= self.quarantine_threshold and learner_id not in self._quarantined
        if entered:
            self._quarantined.add(learner_id)
            self._c_quarantined.add(1)
        self._g_quarantine.set(len(self.quarantined_ids()))
        return entered

    def is_quarantined(self, learner_id: str) -> bool:
        """True while the learner sits inside the quarantine window."""
        if learner_id not in self._quarantined:
            return False
        if self.offense_score(learner_id) < 0.5 * self.quarantine_threshold:
            self._quarantined.discard(learner_id)
            return False
        return True

    def quarantined_ids(self) -> list[str]:
        """Currently quarantined learner ids, in offense-table order."""
        return [lid for lid in self._offenses if self.is_quarantined(lid)]

    # ------------------------------------------------------------- aggregate
    def _commit(self, new_buffer: torch.Tensor) -> None:
        """Server-side optimization + global model swap + version bump.

        Top-k uplinks ship deltas, so the aggregate is a delta too: it is
        folded onto the current global buffer first, which equals dense
        FedAvg when every cohort member trained from the same broadcast.
        """
        if self._topk:
            new_buffer = self.global_buffer + new_buffer
        self._server_state, new_buffer = self.server_opt.apply(
            self._server_state, self.global_buffer, new_buffer
        )
        # The card returns before it finishes: wait for the reduction and the
        # server step, so aggregation_s bounds them, not their launch (and not
        # the learner work other threads queue after them).
        with tracing.Span("controller.commit_wait"):
            wait_queued(self.device)
        self.global_buffer = new_buffer
        self.global_params = packing.unpack_numeric(new_buffer, self.manifest)
        self._model_version += 1
        self._g_version.set(self._model_version)

    def _mask_session_seed(self, epoch: int) -> int:
        """The per-epoch secure mask session (round id / model version key)."""
        return secure_mod.MaskSession(self.secure_seed, epoch).seed

    def aggregate_round(self, selected: list[str]) -> float:
        """Cohort aggregation for round-based policies (paper T4-T7).

        Arena mode: one masked reduction over the persistent device buffer.
        Stack mode: re-stack the stored buffers into an ``(N, P)`` tensor
        first.  Secure mode sums mask-encoded fixed-point rows in a per-round
        mask session.  Commits the result; returns the aggregation seconds.
        """
        with tracing.Span("controller.aggregate", version=self._model_version + 1) as span:
            if self.store_mode == "arena":
                new_buffer = self._aggregate_arena(selected)
            else:
                with self._store_lock:
                    records = self.store.select_latest(list(selected))
                if not records:
                    raise RuntimeError("no local models available to aggregate")
                if self.secure:
                    new_buffer = secure_mod.secure_fedavg(
                        [r.buffer for r in records], [float(r.num_examples) for r in records],
                        base_seed=self._mask_session_seed(self.round_id),
                    )
                else:
                    stack = torch.stack([r.buffer for r in records], dim=0)
                    weights = torch.tensor(
                        [float(r.num_examples) for r in records], dtype=torch.float32,
                        device=self.device,
                    )
                    new_buffer = self.aggregate_fn(stack, weights)
            self._commit(new_buffer)
        return span.seconds

    def _aggregate_arena(self, selected: list[str]) -> torch.Tensor:
        """Masked reduction over the arena restricted to the round's cohort."""
        arena = self.arena
        with arena.lock:
            if self.secure:
                rows, weights = [], []
                for lid in selected:
                    if lid in arena:
                        rows.append(arena.row_of(lid))
                        weights.append(arena.weight_of(lid))
                if not rows:
                    raise RuntimeError("no local models available to aggregate")
                return self._secure_arena_sum(rows, weights,
                                              self._mask_session_seed(self.round_id))
            # Empty-cohort check from the host-side row map: no device sync.
            if arena.num_valid(list(selected)) == 0:
                raise RuntimeError("no local models available to aggregate")
            mask = arena.round_mask(list(selected))
            if arena.arena_dtype == "topk":
                # Masked scatter-accumulate straight off the (n, k) sparse
                # arena: the dense (N, P) stack is never built.
                if self._sharded_topk_fn is not None:
                    out = self._sharded_topk_fn(arena.indices, arena.buffer, arena.weights,
                                                mask)
                else:
                    out = aggregation.masked_fedavg_topk(
                        arena.indices, arena.buffer, arena.weights, mask, arena.padded_params
                    )
                self._c_sparse_agg.add(1)
            elif self.arena_dtype == "int8":
                # Fused dequant-into-aggregate: the reduce reads the int8
                # groups and scales directly, never building (N, P) f32.
                if self._sharded_q8_fn is not None:
                    out = self._sharded_q8_fn(arena.buffer, arena.scales, arena.weights, mask)
                else:
                    out = aggregation.masked_fedavg_q8(
                        arena.buffer, arena.scales, arena.weights, mask, arena.qgroup
                    )
                self._c_fused_agg.add(1)
            elif self._sharded_masked_fn is not None:
                out = self._sharded_masked_fn(arena.buffer, arena.weights, mask)
            else:
                # A custom masked rule sees one (n_max, P) tensor: a sharded
                # arena's shards are assembled on the controller's device.
                buf = arena.buffer.assemble(self.device) if arena.sharded else arena.buffer
                out = self.masked_aggregate_fn(buf, arena.weights, mask)
            return out[: arena.num_params].to(self.device)

    def _secure_arena_sum(self, rows: list[int], weights: list[float],
                          seed: int) -> torch.Tensor:
        """The masked int32 sum over arena rows.  A sharded arena sums its
        full padded width, one accumulator a slot (the reference's choice: the
        padding columns decode to zero), and the result is sliced back."""
        arena = self.arena
        width = arena.padded_params if arena.sharded else arena.num_params
        out = secure_mod.secure_fedavg_arena(
            arena.buffer, rows, weights, num_params=width, base_seed=seed,
            out_sharding=arena.row_sharding,
        )
        return out[: arena.num_params].to(self.device)

    def _staleness_reduce(self, mask: torch.Tensor, alpha: float) -> torch.Tensor:
        """Staleness-damped masked reduce over the arena (caller holds its lock).

        ``s_i = model_version - v_i`` from the per-row versions; the sparse
        arena reduces through the masked scatter-accumulate (counted in
        ``controller.aggregations.sparse_scatter``), the int8 arena through
        the fused dequant-into-aggregate (counted in
        ``controller.aggregations.fused_q8``), the f32 arena through the
        masked FedAvg kernel.
        """
        arena = self.arena
        version = float(self._model_version)
        if arena.arena_dtype == "topk":
            if self._sharded_staleness_topk_fn is not None:
                out = self._sharded_staleness_topk_fn(
                    arena.indices, arena.buffer, arena.weights, arena.versions, version, mask)
            else:
                out = aggregation.masked_staleness_topk(
                    arena.indices, arena.buffer, arena.weights, arena.versions,
                    version, mask, arena.padded_params, alpha,
                )
            self._c_sparse_agg.add(1)
        elif self.arena_dtype == "int8":
            if self._sharded_staleness_q8_fn is not None:
                out = self._sharded_staleness_q8_fn(
                    arena.buffer, arena.scales, arena.weights, arena.versions, version, mask)
            else:
                out = aggregation.masked_staleness_q8(
                    arena.buffer, arena.scales, arena.weights, arena.versions,
                    version, mask, alpha, arena.qgroup,
                )
            self._c_fused_agg.add(1)
        elif self._sharded_staleness_fn is not None:
            out = self._sharded_staleness_fn(
                arena.buffer, arena.weights, arena.versions, version, mask)
        else:
            out = aggregation.masked_staleness_average(
                arena.buffer, arena.weights, arena.versions, version, mask, alpha,
            )
        return out[: arena.num_params].to(self.device)

    def _staleness_stack(self, records: list[ModelRecord], alpha: float) -> torch.Tensor:
        """Staleness-damped reduce of re-stacked stored models (stack mode);
        under ``secure`` the masked fixed-point sum with the same weights,
        computed host-side from the records' metadata."""
        if self.secure:
            weights = [
                float(r.num_examples)
                * (1.0 + self._model_version - r.metadata.get("model_version", 0)) ** (-alpha)
                for r in records
            ]
            return secure_mod.secure_fedavg(
                [r.buffer for r in records], weights,
                base_seed=self._mask_session_seed(self._model_version),
            )
        stal = torch.tensor(
            [self._model_version - r.metadata.get("model_version", 0) for r in records],
            dtype=torch.float32, device=self.device,
        )
        n_ex = torch.tensor([float(r.num_examples) for r in records],
                            dtype=torch.float32, device=self.device)
        stack = torch.stack([r.buffer for r in records], dim=0)
        return self.aggregate_fn(stack, aggregation.staleness_weights(n_ex, stal, alpha))

    def aggregate_community(self) -> float:
        """One staleness-weighted community update (the async policy).

        The arrival that triggered it was already written in place by
        :meth:`ingest`, so the update is one reduce over every valid row,
        whatever the federation's size.  Commits the result; returns the
        aggregation seconds.
        """
        alpha = getattr(self.protocol, "staleness_alpha", 0.5)
        with tracing.Span("controller.aggregate", version=self._model_version + 1) as span:
            if self.store_mode == "arena":
                with self.arena.lock:
                    if self.secure:
                        new_buffer = self._secure_community_arena(alpha)
                    else:
                        new_buffer = self._staleness_reduce(self.arena.mask, alpha)
            else:
                with self._store_lock:
                    records = self.store.select_latest(None)  # all known models
                if not records:
                    raise RuntimeError("no local models available to aggregate")
                new_buffer = self._staleness_stack(records, alpha)
            self._commit(new_buffer)
        return span.seconds

    def aggregate_buffer(self, members: list[str]) -> float:
        """One FedBuff community update over exactly the buffered members.

        Staleness-damped like :meth:`aggregate_community`, but restricted to
        the members' stored rows, folded in **registration order** (not
        arrival order), so the reduce is the same under any executor
        interleaving.  Commits the result; returns the seconds.
        """
        alpha = getattr(self.protocol, "staleness_alpha", 0.5)
        wanted = set(members)
        ordered = [lid for lid in self._learners if lid in wanted]
        with tracing.Span("controller.aggregate", version=self._model_version + 1) as span:
            if not ordered:
                raise RuntimeError("no local models available to aggregate")
            if self.store_mode == "arena":
                arena = self.arena
                with arena.lock:
                    if self.secure:
                        new_buffer = self._secure_community_arena(alpha, members=ordered)
                    else:
                        if arena.num_valid(ordered) == 0:
                            raise RuntimeError("no local models available to aggregate")
                        new_buffer = self._staleness_reduce(arena.round_mask(ordered), alpha)
            else:
                with self._store_lock:
                    records = self.store.select_latest(ordered)
                if not records:
                    raise RuntimeError("no local models available to aggregate")
                new_buffer = self._staleness_stack(records, alpha)
            self._commit(new_buffer)
        return span.seconds

    def _secure_community_arena(
        self, alpha: float, members: list[str] | None = None
    ) -> torch.Tensor:
        """Secure async update off the arena: a staleness-damped masked sum.

        Staleness weights are metadata (example counts and model-version
        lags), computed host-side from the arena's mirrors and folded into the
        fixed-point encoding learner-side, like the FedAvg weights of the
        synchronous secure path.  Mask seeds come from the per-epoch session
        (one per global model version).  ``members`` restricts the sum to
        those learners' valid rows (FedBuff); ``None`` takes every valid row.
        """
        arena = self.arena
        valid = arena.valid_ids()
        ids = [lid for lid in members if lid in set(valid)] if members is not None else valid
        rows, weights = [], []
        for lid in ids:
            stale = float(self._model_version) - arena.version_of(lid)
            rows.append(arena.row_of(lid))
            weights.append(arena.weight_of(lid) * (1.0 + stale) ** (-alpha))
        if not rows:
            raise RuntimeError("no local models available to aggregate")
        return self._secure_arena_sum(rows, weights,
                                      self._mask_session_seed(self._model_version))

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, directory: str | None = None,
                        step: int | None = None) -> str:
        """Persist the full federation state for a crash-consistent resume.

        One ``.npz`` through ``repro_torch.checkpoint``: the global model
        (packed buffer + manifest), the server-optimizer state (its leaves in
        tree order as ``server_state_{i}``), the store contents (arena arrays
        or stack records) and a JSON meta block with the round and version
        counters, learner versions and EWMA profiles, the journal cursor, the
        admission and quarantine state and a telemetry snapshot.  The
        journal's sink is flushed first.  ``directory`` defaults to
        :attr:`checkpoint_dir`, ``step`` to :attr:`round_id`.  Returns the
        file's path.
        """
        from repro_torch.checkpoint import checkpoint as ckpt

        directory = directory if directory is not None else self.checkpoint_dir
        if directory is None:
            raise ValueError("save_checkpoint needs a directory "
                             "(or Controller(checkpoint_dir=...))")
        if self.global_params is None:
            raise RuntimeError("set_initial_model() before save_checkpoint()")
        self.journal.flush()
        step = self.round_id if step is None else int(step)
        leaves, _ = flatten(self._server_state)
        extras: dict[str, Any] = {f"server_state_{i}": leaf for i, leaf in enumerate(leaves)}
        meta: dict[str, Any] = {
            "round_id": int(self.round_id),
            "model_version": int(self._model_version),
            "learner_versions": {k: int(v) for k, v in self._learner_versions.items()},
            "aggregates_fired": int(self.engine.aggregates_fired),
            "profiles": {
                lid: {
                    "decay": prof.decay,
                    "observations": prof.observations,
                    "rep_observations": prof.rep_observations,
                    "data": jsonable(dict(prof)),
                }
                for lid, prof in self._learner_profiles.items()
            },
            "deregistered_at": {k: int(v) for k, v in self._deregistered_at.items()},
            "late_carry": list(self.engine._late_carry),
            "journal_cursor": int(self.journal.cursor),
            "protocol": type(self.protocol).__name__,
            "store_mode": self.store_mode,
            "secure": bool(self.secure),
            "aggregation_rule": self.aggregation_rule,
            "admission": {"ewma": self._adm_ewma, "accepted": int(self._adm_accepted)},
            "offenses": {
                lid: [float(score), int(rnd)] for lid, (score, rnd) in self._offenses.items()
            },
            "quarantined": sorted(self._quarantined),
            "telemetry": self.telemetry.snapshot(),
        }
        if getattr(self.protocol, "continuous", False):
            meta["pending_buffer"] = list(self.engine._buffer)
        if self.engine._pending_dispatch is not None:
            meta["pending_dispatch"] = list(self.engine._pending_dispatch)
        if self.arena is not None:
            st = self.arena.export_state()
            extras["arena_buffer"] = st["buffer"]
            extras["arena_weights"] = st["weights"]
            extras["arena_versions"] = st["versions"]
            extras["arena_valid"] = st["valid"]
            if st.get("scales") is not None:
                extras["arena_scales"] = st["scales"]
            if st.get("indices") is not None:
                extras["arena_indices"] = st["indices"]
            meta["arena_rows"] = {k: int(v) for k, v in st["rows"].items()}
            meta["arena_dtype"] = self.arena_dtype
        elif self.store_mode == "stack":
            records = self.store.export_records()
            meta["stack_records"] = [
                {
                    "learner_id": rec.learner_id,
                    "round_id": int(rec.round_id),
                    "num_examples": int(rec.num_examples),
                    "metadata": jsonable(rec.metadata),
                }
                for rec in records
            ]
            for j, rec in enumerate(records):
                extras[f"stackbuf_{j}"] = rec.buffer
        if self._topk:
            # The learners' error-feedback residuals are federation state:
            # dropping them at resume would re-send mass the carry already
            # accounted for.  The engine checkpoints after draining the tasks
            # in flight, so the residuals are quiescent here.
            meta["sparse_mode"] = self.sparse_mode
            residual_learners = []
            for lid, learner in self._learners.items():
                res = learner.export_residual()
                if res is not None:
                    extras[f"residual__{lid}"] = res
                    residual_learners.append(lid)
            meta["residual_learners"] = residual_learners
        return ckpt.save_checkpoint(
            directory, step, self.global_params, extra_arrays=extras, metadata=meta,
        )

    def restore(self, directory: str | None = None, step: int | None = None) -> dict:
        """Resume from a checkpoint written by :meth:`save_checkpoint`.

        Call on a freshly constructed controller with the *same*
        configuration (protocol, store mode, secure flag, aggregation rule,
        arena dtype: checked against the checkpoint) and the same learners
        already registered.  Restores the global model, the server-optimizer
        state, the round and version counters, the learner profiles, the
        store contents and the journal cursor; the next ``engine.run``
        continues the interrupted workflow and, at matching data and batch
        schedules, produces bit-identical global models.  ``step=None``
        picks the latest checkpoint.  Returns the checkpoint's meta block.
        """
        from repro_torch.checkpoint import checkpoint as ckpt

        directory = directory if directory is not None else self.checkpoint_dir
        if directory is None:
            raise ValueError("restore needs a directory "
                             "(or Controller(checkpoint_dir=...))")
        params, extras, meta = ckpt.restore_checkpoint(directory, step, device=self.device)
        for key, mine in (
            ("protocol", type(self.protocol).__name__),
            ("store_mode", self.store_mode),
            ("secure", bool(self.secure)),
            ("aggregation_rule", self.aggregation_rule),
            ("arena_dtype", self.arena_dtype),
            ("sparse_mode", self.sparse_mode),
        ):
            if key in meta and meta[key] != mine:
                raise ValueError(
                    f"checkpoint was written with {key}={meta[key]!r}; "
                    f"this controller has {key}={mine!r}"
                )
        self.set_initial_model(params)
        # Server-optimizer state: graft the saved leaves onto the structure
        # of the freshly initialized state (same optimizer config, same
        # structure), Python-scalar leaves back as their own type.
        fresh_leaves, structure = flatten(self._server_state)
        restored_leaves = []
        for i, fresh in enumerate(fresh_leaves):
            saved = extras[f"server_state_{i}"]
            if isinstance(fresh, (bool, int, float)):
                restored_leaves.append(type(fresh)(saved.item()))
            else:
                restored_leaves.append(torch.from_numpy(np.array(saved)).to(self.device))
        self._server_state = unflatten(structure, restored_leaves)
        self.round_id = int(meta["round_id"])
        self._model_version = int(meta["model_version"])
        self._g_version.set(self._model_version)
        self._learner_versions.update(
            {k: int(v) for k, v in meta.get("learner_versions", {}).items()}
        )
        self.engine.aggregates_fired = int(meta.get("aggregates_fired", 0))
        for lid, saved_prof in meta.get("profiles", {}).items():
            prof = LearnerProfile(decay=float(saved_prof["decay"]))
            prof.observations = int(saved_prof["observations"])
            prof.rep_observations = int(saved_prof.get("rep_observations", 0))
            prof.update(saved_prof.get("data", {}))
            self._learner_profiles[lid] = prof
        self._deregistered_at = {
            k: int(v) for k, v in meta.get("deregistered_at", {}).items()
        }
        adm = meta.get("admission") or {}
        ewma = adm.get("ewma")
        self._adm_ewma = None if ewma is None else float(ewma)
        self._adm_accepted = int(adm.get("accepted", 0))
        self._offenses = {
            lid: (float(score), int(rnd))
            for lid, (score, rnd) in meta.get("offenses", {}).items()
        }
        self._quarantined = set(meta.get("quarantined", []))
        self._g_quarantine.set(len(self.quarantined_ids()))
        self.engine._late_carry = list(meta.get("late_carry", []))
        self.engine._buffer = list(meta.get("pending_buffer", []))
        if "pending_dispatch" in meta:
            self.engine._resume_dispatch = list(meta["pending_dispatch"])
        if self.arena is not None and "arena_rows" in meta:
            self.arena.restore_state(
                buffer=extras["arena_buffer"],
                weights=extras["arena_weights"],
                versions=extras["arena_versions"],
                valid=extras["arena_valid"],
                rows=meta["arena_rows"],
                scales=extras.get("arena_scales"),
                indices=extras.get("arena_indices"),
            )
        elif self.store_mode == "stack" and "stack_records" in meta:
            self.store.restore_records([
                ModelRecord(
                    learner_id=rec["learner_id"],
                    round_id=int(rec["round_id"]),
                    buffer=torch.from_numpy(np.array(extras[f"stackbuf_{j}"])).to(self.device),
                    num_examples=int(rec["num_examples"]),
                    metadata=dict(rec.get("metadata", {})),
                )
                for j, rec in enumerate(meta["stack_records"])
            ])
        for lid in meta.get("residual_learners", []):
            learner = self._learners.get(lid)
            if learner is not None:
                learner.restore_residual(extras[f"residual__{lid}"])
        self.invalidate_wire_cache()
        self.journal.seek(int(meta.get("journal_cursor", 0)))
        return meta

    # -------------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        """Stop the engine's dispatch executor (waits for in-flight tasks)."""
        self.engine.shutdown()
