"""Unified telemetry registry: the controller's single metrics surface.

MetisFL treats the controller as the first-class citizen of an FL system;
this module is where its runtime state becomes *observable*.  Every counter
that used to live as a bespoke attribute — ``ChannelStats`` fields,
``ArenaStore.bytes_ingested``, ``Controller.dispatch_serializations`` — is
now an instrument registered in one :class:`Telemetry` registry, reachable
through ``controller.telemetry``:

* :class:`Counter` — monotonically increasing totals (messages, bytes,
  serializations, cumulative seconds).
* :class:`Gauge` — last-set point-in-time values (current model version,
  round id).
* :class:`Histogram` — streaming summaries (count/sum/min/max/last) of
  per-event observations (per-round wall-clock, aggregation seconds).

``snapshot()`` renders the whole registry as one JSON-able dict.  Names are
dotted paths (``channel.upload_bytes``, ``store.arena.total_writes``,
``controller.dispatch_serializations``) and are the same as the reference's
(``repro/core/metrics.py``, of which this module is a framework-free copy);
the catalogue lives in ``docs/OBSERVABILITY.md``.

Thread-safety: each instrument mutates under its own lock and the registry
itself locks get-or-create, so executor threads (the engine's dispatch pool)
can bump counters concurrently with a ``snapshot()`` reader.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "Telemetry"]


class Counter:
    """A monotonically increasing total (int or float).

    ``add`` is the only mutator; integer adds keep the value an ``int`` so
    exact-count assertions (``stats.messages == 3``) stay exact.
    """

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value: int | float = 0

    @property
    def value(self) -> int | float:
        """The current cumulative total."""
        with self._lock:
            return self._value

    def add(self, n: int | float = 1) -> None:
        """Increase the total by ``n`` (must be >= 0: counters never go down)."""
        if n < 0:
            raise ValueError(f"counter {self.name}: add() must be >= 0, got {n}")
        with self._lock:
            self._value += n

    def render(self) -> int | float:
        """The snapshot representation (the scalar total)."""
        return self.value


class Gauge:
    """A point-in-time value: the last ``set()`` wins."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value: int | float = 0

    @property
    def value(self) -> int | float:
        """The most recently set value."""
        with self._lock:
            return self._value

    def set(self, v: int | float) -> None:
        """Record the current value (overwrites the previous one)."""
        with self._lock:
            self._value = v

    def render(self) -> int | float:
        """The snapshot representation (the scalar value)."""
        return self.value


class Histogram:
    """A streaming summary of per-event observations.

    Tracks ``count``/``sum``/``min``/``max``/``last`` — enough for the
    bench artifacts (mean = sum/count) without storing samples.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def observe(self, v: float) -> None:
        """Fold one observation into the summary."""
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.last = v

    @property
    def mean(self) -> float:
        """Mean observation (0.0 before the first observe)."""
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def render(self) -> dict:
        """The snapshot representation: a count/sum/min/max/last dict."""
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "last": 0.0}
            return {"count": self.count, "sum": self.sum, "min": self.min,
                    "max": self.max, "last": self.last}


class Telemetry:
    """The instrument registry — one per federation (``controller.telemetry``).

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    registers the instrument, later calls return the same object (asking for
    an existing name with a different instrument kind raises).  ``value``
    reads one instrument's scalar; ``snapshot`` renders everything at once.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"telemetry name {name!r} is a {inst.kind}, not a "
                    f"{cls.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        """Get or create the :class:`Counter` registered under ``name``."""
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get or create the :class:`Gauge` registered under ``name``."""
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        """Get or create the :class:`Histogram` registered under ``name``."""
        return self._get_or_create(Histogram, name, help)

    def get(self, name: str):
        """The instrument registered under ``name`` (None if absent)."""
        with self._lock:
            return self._instruments.get(name)

    def value(self, name: str, default: int | float = 0) -> int | float:
        """One instrument's scalar value (histograms: their mean).

        The single read API the observability surface consolidates on:
        ``controller.telemetry.value("channel.upload_bytes")`` replaces the
        old direct attribute pokes.  ``default`` is returned for names that
        were never registered.
        """
        inst = self.get(name)
        if inst is None:
            return default
        if isinstance(inst, Histogram):
            return inst.mean
        return inst.value

    def names(self) -> list[str]:
        """Every registered instrument name, sorted."""
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """Render the whole registry as one JSON-able dict.

        Counters and gauges render as scalars, histograms as their
        count/sum/min/max/last summary.  This is the payload the journal's
        round records and the nightly bench JSON embed.
        """
        with self._lock:
            instruments = list(self._instruments.values())
        return {inst.name: inst.render() for inst in sorted(
            instruments, key=lambda i: i.name)}
