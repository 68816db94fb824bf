"""The controller flight recorder: an append-only, replayable event journal.

Every typed event the round engine processes (``Dispatched`` /
``UploadArrived`` / ``AggregateFired`` / ``Evaluated`` / ``EngineStopped``)
is serialized into one compact JSON-able record and appended here, in
processing order.  The journal is the engine's durable observability
surface: the in-memory ``event_log`` deque holds the typed objects for
tests; the journal holds their wire form — taggable, greppable, tailable.

Design constraints (the engine loop is latency-critical):

* **No arrays, no pytrees** — records carry ids, counts and byte sizes, not
  model state.  Serializing a record is dict construction only; JSON
  encoding happens at flush time.
* **No sink I/O on the loop thread** — with a file sink attached, records
  are buffered and drained by a background flush thread; ``record()`` never
  blocks on the filesystem.  The ``EngineStopped`` record triggers a
  synchronous :meth:`flush`, so when ``engine.run()`` returns the sink holds
  every record (the flush-on-stop guarantee).
* **Deterministic under test** — timestamps come from an injectable
  ``clock`` hook; with a fixed clock, two identical runs produce identical
  JSONL byte-for-byte (``tests/test_journal.py``).

:meth:`replay` folds a record stream back into per-round
:class:`RoundSummary` objects — cohort membership, arrival order, staleness
histogram, policy decisions, wire bytes up/down — the per-round provenance
view that tests assert on and ``launch/serve.py``-style tooling can tail.
Schema reference: ``docs/OBSERVABILITY.md``.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import math
import threading
import time
from typing import Any, Callable, Iterable

import torch

__all__ = ["EventJournal", "RoundSummary", "jsonable"]


def jsonable(obj: Any) -> Any:
    """Coerce a value into plain JSON types (dicts/lists/str/int/float/bool).

    Numpy and torch zero-dim scalars become Python numbers, larger torch
    tensors nested lists; unknown objects fall back to ``repr`` — a journal
    record must always serialize, whatever a learner put in its metrics dict.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor) and obj.ndim > 0:
        return jsonable(obj.detach().cpu().tolist())
    item = getattr(obj, "item", None)
    if callable(item) and getattr(obj, "ndim", None) in (0, None):
        try:
            return jsonable(item())
        except (TypeError, ValueError):
            pass
    return repr(obj)


@dataclasses.dataclass
class RoundSummary:
    """Per-round provenance reconstructed from the journal by :meth:`replay`.

    ``cohort`` lists dispatched learners in dispatch order; ``arrivals``
    lists uploads in processing order; ``staleness`` histograms the model-
    version lag of each arrival (``{lag: count}``).  ``down_bytes`` /
    ``up_bytes`` are this round's wire deltas (cumulative channel totals at
    the aggregate, minus the previous round's).  ``weighting`` / ``trigger``
    record the policy decision that fired the aggregate; ``metrics`` is the
    reduced eval report (round-based policies only).

    The admission-control fields answer "why is this learner's row not in
    the aggregate": ``rejected`` lists ``{"learner", "reason", "norm"}``
    dicts for uploads the screen refused (the row never touched the store),
    ``clipped`` lists learners whose upload was norm-clipped before the row
    write (still aggregated, at reduced magnitude), and ``quarantined``
    lists learners that crossed the quarantine threshold during the round
    (excluded from *subsequent* cohort selection until decay releases them).
    """

    round_id: int
    cohort: list = dataclasses.field(default_factory=list)
    arrivals: list = dataclasses.field(default_factory=list)
    staleness: dict = dataclasses.field(default_factory=dict)
    rejected: list = dataclasses.field(default_factory=list)
    clipped: list = dataclasses.field(default_factory=list)
    quarantined: list = dataclasses.field(default_factory=list)
    aggregated: bool = False
    n_arrived: int = 0
    weighting: str | None = None
    trigger: str | None = None
    model_version: int | None = None
    down_bytes: int | None = None
    up_bytes: int | None = None
    metrics: dict = dataclasses.field(default_factory=dict)


class EventJournal:
    """Thread-safe append-only journal of the engine's typed events.

    ``capacity`` bounds the in-memory ring (0 disables recording entirely —
    the bench baseline); ``sink`` optionally persists records as JSONL (a
    path string or a writable text-file object); ``clock`` injects
    timestamps (``time.time`` by default; tests pass a counter for
    deterministic output).  ``cursor`` is the total number of records ever
    recorded — it rides along in federation checkpoints so a resumed
    engine's records continue the sequence numbering.
    """

    def __init__(
        self,
        capacity: int = 4096,
        sink: Any = None,
        clock: Callable[[], float] = time.time,
        flush_interval_s: float = 0.05,
    ):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.flush_interval_s = float(flush_interval_s)
        self._sink_spec = sink
        self._sink_file: Any = None
        self._owns_sink = isinstance(sink, str)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._pending: list[dict] = []
        self._seq = 0
        self._sink_lock = threading.Lock()
        self._flusher: threading.Thread | None = None
        self._wake = threading.Event()
        self._stop = False

    # -- recording ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """False when nothing is retained (capacity 0 and no sink)."""
        return self.capacity > 0 or self._sink_spec is not None

    @property
    def cursor(self) -> int:
        """Total records ever recorded (== the next record's ``seq``)."""
        with self._lock:
            return self._seq

    def seek(self, cursor: int) -> None:
        """Reset the sequence counter (checkpoint restore: records resume
        numbering where the interrupted run's journal left off)."""
        with self._lock:
            self._seq = int(cursor)

    def record(self, event: Any, **context: Any) -> dict | None:
        """Serialize one typed event (plus caller context) and append it.

        Called by the engine loop for every event it processes.  The record
        is a flat dict — ``seq`` (processing order), ``t`` (clock hook),
        ``kind`` plus the event's scalar fields and any ``context`` the
        engine attached (byte sizes, staleness, model version).  With a file
        sink the record is buffered for the background flusher; an
        ``engine_stopped`` record flushes synchronously (the flush-on-stop
        guarantee).  Returns the record (None when recording is disabled).
        """
        if not self.enabled:
            return None
        payload = _serialize_event(event)
        if context:
            payload.update({k: jsonable(v) for k, v in context.items()})
        with self._lock:
            rec = {"seq": self._seq, "t": float(self.clock()), **payload}
            self._seq += 1
            if self.capacity:
                self._ring.append(rec)
            if self._sink_spec is not None:
                self._pending.append(rec)
        if self._sink_spec is not None:
            if payload.get("kind") == "engine_stopped":
                self.flush()
            else:
                self._ensure_flusher()
                self._wake.set()
        return rec

    def records(self) -> list[dict]:
        """A copy of the in-memory ring, in processing order."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    # -- sink / flushing ----------------------------------------------------
    def _ensure_flusher(self) -> None:
        if self._flusher is not None or self._stop:
            return
        with self._sink_lock:
            if self._flusher is None and not self._stop:
                t = threading.Thread(
                    target=self._flush_loop, name="journal-flush", daemon=True
                )
                self._flusher = t
                t.start()

    def _flush_loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            self._drain()

    def _open_sink(self):
        if self._sink_file is None:
            if self._owns_sink:
                self._sink_file = open(self._sink_spec, "a", encoding="utf-8")
            else:
                self._sink_file = self._sink_spec
        return self._sink_file

    def _drain(self) -> None:
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        with self._sink_lock:
            f = self._open_sink()
            for rec in batch:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()

    def flush(self) -> None:
        """Synchronously drain buffered records to the sink (no-op without one)."""
        if self._sink_spec is None:
            return
        self._drain()

    def close(self) -> None:
        """Stop the background flusher, flush, and close an owned sink file."""
        self._stop = True
        self._wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        self._drain()
        if self._owns_sink and self._sink_file is not None:
            self._sink_file.close()
            self._sink_file = None

    # -- serialization ------------------------------------------------------
    def to_jsonl(self, records: Iterable[dict] | None = None) -> str:
        """Render records (default: the ring) as one JSONL string."""
        out = io.StringIO()
        for rec in self.records() if records is None else records:
            out.write(json.dumps(rec, sort_keys=True) + "\n")
        return out.getvalue()

    @staticmethod
    def read_jsonl(path: str) -> list[dict]:
        """Load a journal sink file back into a list of records."""
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]

    # -- replay -------------------------------------------------------------
    def replay(self, records: Iterable[dict] | None = None) -> list[RoundSummary]:
        """Fold a record stream into per-round :class:`RoundSummary` objects.

        Defaults to the in-memory ring; pass ``read_jsonl(path)`` records to
        replay a sink file (e.g. after a crash).  Summaries come back sorted
        by round id; rounds that never aggregated (in-flight at shutdown)
        appear with ``aggregated=False``.
        """
        recs = self.records() if records is None else list(records)
        rounds: dict[int, RoundSummary] = {}

        def summary(rid: int) -> RoundSummary:
            return rounds.setdefault(int(rid), RoundSummary(round_id=int(rid)))

        prev_down = prev_up = 0
        for rec in recs:
            kind = rec.get("kind")
            rid = rec.get("round")
            if kind == "dispatch" and rid is not None:
                summary(rid).cohort.append(rec.get("learner"))
            elif kind == "upload" and rid is not None:
                s = summary(rid)
                s.arrivals.append(rec.get("learner"))
                lag = rec.get("staleness")
                if lag is not None:
                    lag = int(lag)
                    s.staleness[lag] = s.staleness.get(lag, 0) + 1
            elif kind == "aggregate" and rid is not None:
                s = summary(rid)
                s.aggregated = True
                s.n_arrived = int(rec.get("n_arrived", 0))
                s.weighting = rec.get("weighting")
                s.trigger = rec.get("trigger")
                if rec.get("model_version") is not None:
                    s.model_version = int(rec["model_version"])
                down, up = rec.get("bytes_down"), rec.get("bytes_up")
                if down is not None:
                    s.down_bytes = int(down) - prev_down
                    prev_down = int(down)
                if up is not None:
                    s.up_bytes = int(up) - prev_up
                    prev_up = int(up)
            elif kind == "upload_rejected" and rid is not None:
                summary(rid).rejected.append({
                    "learner": rec.get("learner"),
                    "reason": rec.get("reason"),
                    "norm": rec.get("norm"),
                })
            elif kind == "upload_clipped" and rid is not None:
                summary(rid).clipped.append(rec.get("learner"))
            elif kind == "quarantine" and rid is not None:
                summary(rid).quarantined.append(rec.get("learner"))
            elif kind == "evaluate" and rid is not None:
                summary(rid).metrics = rec.get("metrics", {})
        return [rounds[k] for k in sorted(rounds)]


def _serialize_event(event: Any) -> dict:
    """One typed engine event → its flat JSON-able payload.

    Matched by class name (the engine imports the journal, not vice versa).
    Unknown event types — anything tests or tooling post through
    ``engine.post`` — serialize as ``kind="external"`` with their type name;
    a journal record must never fail to serialize.
    """
    name = type(event).__name__
    if name == "Dispatched":
        task = event.task
        return {
            "kind": "dispatch",
            "round": int(event.round_id),
            "learner": event.learner_id,
            "local_steps": int(task.local_steps),
            "batch_size": int(task.batch_size),
        }
    if name == "UploadArrived":
        if event.update is None:
            return {"kind": "upload", "round": None, "learner": None,
                    "error": repr(event.error)}
        u = event.update
        return {
            "kind": "upload",
            "round": int(u.round_id),
            "learner": u.learner_id,
            "num_examples": int(u.num_examples),
        }
    if name == "AggregateFired":
        out = {
            "kind": "aggregate",
            "round": int(event.round_id),
            "n_arrived": int(event.n_arrived),
            "trigger": event.trigger,
        }
        if getattr(event, "members", None):
            out["members"] = list(event.members)
        return out
    if name == "UploadRejected":
        norm = float(event.norm)
        return {
            "kind": "upload_rejected",
            "round": int(event.round_id),
            "learner": event.learner_id,
            "reason": event.reason,
            # NaN/inf norms (the usual rejection cause) are not JSON —
            # stringify so sink files stay loadable by strict parsers.
            "norm": norm if math.isfinite(norm) else repr(norm),
        }
    if name == "UploadClipped":
        return {
            "kind": "upload_clipped",
            "round": int(event.round_id),
            "learner": event.learner_id,
            "norm": float(event.norm),
            "limit": float(event.limit),
        }
    if name == "LearnerQuarantined":
        return {
            "kind": "quarantine",
            "round": int(event.round_id),
            "learner": event.learner_id,
            "score": float(event.score),
        }
    if name == "DeadlineExpired":
        return {"kind": "deadline", "round": int(event.round_id)}
    if name == "Evaluated":
        return {
            "kind": "evaluate",
            "round": int(event.round_id),
            "metrics": jsonable(event.metrics),
        }
    if name == "EngineStopped":
        return {
            "kind": "engine_stopped",
            "completed": int(event.completed),
            "error": event.error,
        }
    return {"kind": "external", "type": name}
