"""Spans: the controller's and the learners' work timed from inside, journaled
on the profiler's clock.

A :class:`Span` times one interval with two readings of the monotonic
``time.perf_counter_ns()``, one a boundary.  The readings are always taken:
the channel's ``*_s`` counters, ``RoundTimings.aggregation_s`` and
``LocalUpdate.seconds_per_step`` are spans' :attr:`Span.seconds`.

Only while :func:`active` (a ``torch.profiler`` session collects) does a span
also hand a record to the sink :func:`bind` gave its thread: the engine's
journal, bound by each worker to its task and by the loop to the arrival it
handles.  A recorded span's times are moved onto the epoch by one offset
taken at import (``time.time_ns() - time.perf_counter_ns()``, where the two
clocks' reads lie closest together), so they share the clock of the
journal's records (``EventJournal``'s default clock is ``time.time``) and
of the profiler's events (epoch nanoseconds).  The two
clocks are slewed alike; only a step of the wall clock moves them apart.
A span that was open when the profiler started or stopped records nothing.
Without a profiler a span costs one flag read beside its clock readings, and
the journal holds exactly what it held before spans.

A record: ``{"kind": "span.<name>", "t", "t_end", "task", "learner",
"parent", ...fields}``; ``parent`` is the name of the span open around it on
the same thread, and a :class:`Span`'s fields end with ``cpu_s``, its
thread's CPU seconds inside it.  The catalogue is in ``docs/TORCH_SPANS.md``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator

import torch.autograd.profiler as _profiler

__all__ = ["Span", "active", "bind", "close", "mark"]


def _epoch_offset(samples: int = 16) -> int:
    """Nanoseconds from the monotonic clock to the epoch: of ``samples``
    wall-clock readings, the one bracketed most tightly by two monotonic
    ones, so a thread preempted between the reads cannot skew the offset."""
    best = None
    for _ in range(samples):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, wall - (before + after) // 2)
    return best[1]


# The offset of recorded spans' times, taken once.
_EPOCH_NS = _epoch_offset()

# Per thread: ``bound`` (sink, task, learner) from :func:`bind`, and ``open``,
# the names of the recording spans open on the thread, innermost last.
_local = threading.local()


def active() -> bool:
    """True while a torch profiler collects: the process-wide flag its
    sessions set, true on every thread (the autograd profiler's own
    per-thread state is not)."""
    return _profiler._is_profiler_enabled


@contextlib.contextmanager
def bind(sink: Any, task: int | None = None, learner: str | None = None) -> Iterator[None]:
    """Inside the block, spans closed on this thread record to ``sink`` (an
    object with ``record_span(name, t, t_end, **fields)``), stamped with
    ``task`` and ``learner``."""
    prev = getattr(_local, "bound", None)
    _local.bound = (sink, task, learner)
    try:
        yield
    finally:
        _local.bound = prev


def _open() -> list[str]:
    opened = getattr(_local, "open", None)
    if opened is None:
        opened = _local.open = []
    return opened


def _record(name: str, t: int, t_end: int, fields: dict) -> None:
    bound = getattr(_local, "bound", None)
    if bound is None or not active():
        return
    sink, task, learner = bound
    opened = _open()
    sink.record_span(name, (t + _EPOCH_NS) / 1e9, (t_end + _EPOCH_NS) / 1e9, task=task,
                     learner=learner, parent=opened[-1] if opened else None, **fields)


class Span:
    """``with Span(name, **fields) as s: ...``, then ``s.seconds``.

    ``fields`` may be added to inside the block; ``recording`` says whether
    the span will be recorded, so a field that costs a clock reading is
    taken only then.
    """

    __slots__ = ("name", "fields", "t", "t_end", "recording", "_cpu")

    def __init__(self, name: str, **fields: Any):
        self.name = name
        self.fields = fields

    def __enter__(self) -> "Span":
        self.recording = active()
        if self.recording:
            _open().append(self.name)
        self.t = time.perf_counter_ns()
        if self.recording:
            self._cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.recording:
            # The thread's CPU seconds inside the span: the rest of it the
            # thread waited (for the GIL, a blocked CUDA call, the stream).
            self.fields["cpu_s"] = (time.thread_time_ns() - self._cpu) / 1e9
        self.t_end = time.perf_counter_ns()
        if self.recording:
            _open().pop()
            _record(self.name, self.t, self.t_end, self.fields)

    def elapsed(self) -> float:
        """Seconds since the span opened (one more clock reading)."""
        return (time.perf_counter_ns() - self.t) / 1e9

    @property
    def seconds(self) -> float:
        """The closed span's length."""
        return (self.t_end - self.t) / 1e9


def mark() -> int | None:
    """The start of a span that :func:`close` ends, on another thread or
    later: a clock reading while :func:`active`, else None."""
    return time.perf_counter_ns() if active() else None


def close(name: str, start: int | None, **fields: Any) -> None:
    """Record the span ``[start, now]`` through this thread's sink, if
    ``start`` came from :func:`mark` and the profiler still collects."""
    if start is not None:
        _record(name, start, time.perf_counter_ns(), fields)
