"""The program's spans in the traced window, for the per-layer readers.

The port journals a span (``repro_torch/core/tracing.py``) only while a
torch profiler collects, as a record ``{"kind": "span.<name>", "t", "t_end",
"task", "learner", "parent", ...fields}`` whose ``t`` and ``t_end`` share the
clock of the other records and of ``TraceSummary.host_t0``.  A span belongs to
the traced window when it starts inside ``[host_t0, host_t0 + window_s]``.
A program without spans, or a run without a trace, yields none, and every
helper then returns ``None``.
"""

from __future__ import annotations


def window_records(run, kind: str) -> list[dict]:
    """The records of ``kind`` (a span's is ``span.<name>``) stamped inside
    the traced window."""
    if run.trace is None:
        return []
    lo = run.trace.host_t0
    hi = lo + run.trace.window_s
    return [r for r in run.records if r["kind"] == kind and lo <= r["t"] <= hi]


def window_spans(run, name: str, since: float | None = None, **match) -> list[dict]:
    """The records of span ``name`` that start inside the traced window (and
    not before ``since``) and whose fields equal ``match``."""
    return [r for r in window_records(run, f"span.{name}")
            if (since is None or r["t"] >= since)
            and all(r.get(k) == v for k, v in match.items())]


def total_s(run, *names: str) -> float | None:
    """The summed seconds of the window's spans of ``names``; None without any."""
    recs = [r for name in names for r in window_spans(run, name)]
    return sum(r["t_end"] - r["t"] for r in recs) if recs else None


def per_step_s(run, *names: str) -> float | None:
    """:func:`total_s` over the rounds or updates committed in the window."""
    total = total_s(run, *names)
    if total is None or run.traced_steps <= 0:
        return None
    return total / run.traced_steps


def mean_s(run, name: str, since: float | None = None, **match) -> float | None:
    """The mean seconds of the window's spans of ``name`` matching ``match``
    (and starting at ``since`` or later)."""
    recs = window_spans(run, name, since, **match)
    return sum(r["t_end"] - r["t"] for r in recs) / len(recs) if recs else None


def union_s(run, *names: str) -> float | None:
    """The seconds inside the window covered by at least one span of
    ``names`` (overlaps counted once, spans cut at the window's end)."""
    recs = [r for name in names for r in window_spans(run, name)]
    if not recs:
        return None
    hi = run.trace.host_t0 + run.trace.window_s
    covered, reach = 0.0, run.trace.host_t0
    for r in sorted(recs, key=lambda r: r["t"]):
        start, end = max(r["t"], reach), min(r["t_end"], hi)
        if end > start:
            covered += end - start
        reach = max(reach, end)
    return covered
