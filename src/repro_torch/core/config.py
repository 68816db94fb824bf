"""Typed federation configuration: the controller/transport knob surface.

A framework-free copy of ``repro/core/config.py``: the same fields, defaults
and validation, so one configuration describes a federation in both
packages; every knob runs, ``arena_shards`` included (``Driver`` builds
its slot mesh).  :class:`FederationConfig` is one frozen, validated
dataclass:

* every knob is declared once, with its default and its validity range
  (``__post_init__`` rejects bad values at construction, not three layers
  down inside the engine);
* :meth:`FederationConfig.from_kwargs` builds a config from loose keyword
  arguments and rejects unknown keys by name — the typo-proof entry point
  for YAML/CLI front-ends;
* ``FederationEnv(config=...)`` (``core/driver.py``) is the documented way
  to configure a federation; the legacy flat fields remain as aliases that
  populate (or are populated from) the config.

The training-loop knobs (protocol, steps, batch size, learning rates,
termination) stay on :class:`~repro_torch.core.driver.FederationEnv` — they
describe the *workflow*; this config describes the *machinery* underneath.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["FederationConfig"]

_STORE_MODES = ("auto", "arena", "stack")
_UPLOAD_CODECS = ("raw", "int8", "topk")
_AGGREGATION_RULES = ("fedavg", "median", "trimmed_mean")
_ARENA_DTYPES = ("f32", "int8")
_SPARSE_MODES = ("direct", "densify")


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """The controller-machinery knobs, typed and validated.

    Parameters
    ----------
    store_mode:
        ``"auto"`` (default) picks the legacy hash-map store when its
        exclusive features (lineage > 1, byte-capacity eviction) are
        configured and the device-resident arena otherwise; ``"arena"`` /
        ``"stack"`` force a backing.
    arena_shards:
        0 = single-device arena; N > 0 column-shards over an N-device mesh;
        -1 shards over every visible device.
    upload_codec:
        Uplink wire format: ``"raw"`` (bit-transparent f32), ``"int8"``
        (blockwise quantization) or ``"topk"`` (magnitude top-k delta
        sparsification with learner-side error feedback — requires
        ``flat_uploads``; see ``docs/DISPATCH.md``).
    flat_uploads:
        Ship the wire manifest at registration so uploads arrive as packed
        flat buffers (the fast path); False keeps pack-on-arrival parity.
    wire_aware:
        Semi-sync only: subtract modeled round-trip wire time from the
        hyper-period step budget.
    profile_decay:
        EWMA decay for the per-learner seconds-per-step estimate, in
        ``[0, 1)``; 0 reproduces last-sample behaviour.
    prox_mu:
        FedProx proximal coefficient (>= 0; 0 disables the proximal term).
    checkpoint_every / checkpoint_dir:
        Crash-consistency cadence: every k completed rounds the engine
        persists the federation state into ``checkpoint_dir``
        (``Controller.save_checkpoint``); both must be set to take effect.
    journal_sink / journal_capacity:
        The engine flight recorder (``core/journal.EventJournal``): an
        optional JSONL sink (path or file object) and the in-memory ring
        bound (0 disables recording).
    aggregation_rule:
        The community-model reduction: ``"fedavg"`` (weighted mean, the
        default), ``"median"`` (coordinate-wise median) or
        ``"trimmed_mean"`` (drop the ``trim_k`` extremes per coordinate per
        side).  The robust rules are order statistics — weight-blind and
        byzantine-tolerant — and are rejected by the staleness-weighted
        protocols (async/FedBuff), whose damping has no order-statistic
        analogue (see docs/PROTOCOLS.md support matrix).
    trim_k:
        Rows trimmed per side by ``"trimmed_mean"`` (>= 1; ignored by the
        other rules).  Must satisfy ``2 * trim_k < n_live`` at aggregate
        time; the arena capacity bound is checked at setup.
    arena_dtype:
        Resident precision of the arena rows: ``"f32"`` (default) keeps
        full-precision rows; ``"int8"`` keeps blockwise-quantized rows
        (int8 groups + per-group f32 scales, ~4x less device memory) and
        aggregates through the fused dequant-into-aggregate path.
        Requires an arena store with the default ``"fedavg"`` rule and no
        secure aggregation — see the support matrix in ``docs/ARENA.md``.
    sparse_mode:
        How a ``"topk"`` upload lands in the store: ``"densify"`` (default)
        scatters the sparse delta into the existing dense f32/int8 row, so
        every store mode and aggregation rule keeps working; ``"direct"``
        keeps the ``(n_max, k)`` index/value arena resident and aggregates
        through the masked scatter-accumulate — the fast path, restricted
        to an arena store with ``"fedavg"``/staleness weighting and the
        default f32 rows.  Ignored (must stay ``"densify"``) for the dense
        codecs — see the support matrix in ``docs/ARENA.md``.
    """

    store_mode: str = "auto"
    arena_shards: int = 0
    upload_codec: str = "raw"
    flat_uploads: bool = True
    wire_aware: bool = True
    profile_decay: float = 0.5
    prox_mu: float = 0.0
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None
    journal_sink: Any = None
    journal_capacity: int = 4096
    aggregation_rule: str = "fedavg"
    trim_k: int = 1
    arena_dtype: str = "f32"
    sparse_mode: str = "densify"

    def __post_init__(self) -> None:
        """Validate every knob at construction time."""
        if self.store_mode not in _STORE_MODES:
            raise ValueError(
                f"store_mode must be one of {_STORE_MODES}, "
                f"got {self.store_mode!r}"
            )
        if not isinstance(self.arena_shards, int) or self.arena_shards < -1:
            raise ValueError(
                f"arena_shards must be an int >= -1, got {self.arena_shards!r}"
            )
        if self.arena_shards and self.store_mode == "stack":
            raise ValueError(
                "arena_shards requires an arena store; it cannot combine "
                "with store_mode='stack'"
            )
        if (
            isinstance(self.upload_codec, str)
            and self.upload_codec not in _UPLOAD_CODECS
        ):
            raise ValueError(
                f"upload_codec must be one of {_UPLOAD_CODECS} (or a codec "
                f"object), got {self.upload_codec!r}"
            )
        if not 0.0 <= float(self.profile_decay) < 1.0:
            raise ValueError(
                f"profile_decay must be in [0, 1), got {self.profile_decay!r}"
            )
        if float(self.prox_mu) < 0.0:
            raise ValueError(f"prox_mu must be >= 0, got {self.prox_mu!r}")
        if self.checkpoint_every is not None and int(self.checkpoint_every) < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 (or None), "
                f"got {self.checkpoint_every!r}"
            )
        if int(self.journal_capacity) < 0:
            raise ValueError(
                f"journal_capacity must be >= 0, got {self.journal_capacity!r}"
            )
        if self.aggregation_rule not in _AGGREGATION_RULES:
            raise ValueError(
                f"aggregation_rule must be one of {_AGGREGATION_RULES}, "
                f"got {self.aggregation_rule!r}"
            )
        if not isinstance(self.trim_k, int) or self.trim_k < 1:
            raise ValueError(f"trim_k must be an int >= 1, got {self.trim_k!r}")
        if self.arena_dtype not in _ARENA_DTYPES:
            raise ValueError(
                f"arena_dtype must be one of {_ARENA_DTYPES}, "
                f"got {self.arena_dtype!r}"
            )
        if self.arena_dtype == "int8" and self.store_mode == "stack":
            raise ValueError(
                "arena_dtype='int8' requires an arena store; it cannot "
                "combine with store_mode='stack'"
            )
        if self.arena_dtype == "int8" and self.aggregation_rule != "fedavg":
            raise ValueError(
                "arena_dtype='int8' supports only aggregation_rule='fedavg'; "
                "the robust order-statistic rules sort full-precision rows "
                f"(got {self.aggregation_rule!r}) — see docs/ARENA.md"
            )
        if self.sparse_mode not in _SPARSE_MODES:
            raise ValueError(
                f"sparse_mode must be one of {_SPARSE_MODES}, "
                f"got {self.sparse_mode!r}"
            )
        is_topk = self.upload_codec == "topk" or (
            not isinstance(self.upload_codec, str)
            and getattr(self.upload_codec, "codec_id", None) == "topk"
        )
        if is_topk and not self.flat_uploads:
            raise ValueError(
                "upload_codec='topk' requires flat_uploads=True: the "
                "error-feedback residual lives learner-side against the "
                "shipped wire manifest"
            )
        if self.sparse_mode == "direct":
            if not is_topk:
                raise ValueError(
                    "sparse_mode='direct' requires upload_codec='topk' "
                    f"(got {self.upload_codec!r})"
                )
            if self.store_mode == "stack":
                raise ValueError(
                    "sparse_mode='direct' requires an arena store; it "
                    "cannot combine with store_mode='stack'"
                )
            if self.aggregation_rule != "fedavg":
                raise ValueError(
                    "sparse_mode='direct' supports only "
                    "aggregation_rule='fedavg'; the robust order-statistic "
                    "rules need dense rows — use sparse_mode='densify' "
                    f"(got {self.aggregation_rule!r})"
                )
            if self.arena_dtype != "f32":
                raise ValueError(
                    "sparse_mode='direct' keeps its own (n, k) sparse "
                    "arena; it cannot combine with "
                    f"arena_dtype={self.arena_dtype!r}"
                )

    @classmethod
    def from_kwargs(cls, **kwargs: Any) -> "FederationConfig":
        """Build a config from loose keyword arguments, typo-proof.

        Unknown keys raise ``TypeError`` naming the valid fields — the
        entry point for YAML/CLI front-ends that collect knobs as dicts.
        """
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kwargs) - known)
        if unknown:
            raise TypeError(
                f"unknown FederationConfig field(s) {unknown}; "
                f"valid fields: {sorted(known)}"
            )
        return cls(**kwargs)

    def replace(self, **changes: Any) -> "FederationConfig":
        """A copy with the given fields changed (re-validated)."""
        return dataclasses.replace(self, **changes)
