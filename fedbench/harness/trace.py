"""The traced window: ``torch.profiler`` over part of the measured window,
reduced to what the per-layer metrics read.

Only device activity is kept: every kernel, copy and memset the profiler
recorded between the window's two markers (``record_function`` ranges on the
thread that starts and stops it), with its name and device interval.  From
them: the seconds the device was busy (the union of the intervals), the
copies' device seconds, each kernel's calls, and the longest idle gaps,
each named by the engine's last journal record before it (what the host was
doing).
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch

COPY = re.compile(r"^Memcpy (HtoD|DtoH)")


@dataclasses.dataclass
class DeviceOp:
    """One device activity: its name and interval, in the profiler's ns."""

    name: str
    start: int
    end: int


@dataclasses.dataclass
class TraceSummary:
    """What the readers take from a traced window."""

    window_s: float
    busy_s: float
    copy_s: float
    ops: list[DeviceOp]  # in start order
    host_t0: float  # time.time() at the window's start marker
    ns_t0: int  # the profiler's clock at that marker

    def calls(self, pattern: str) -> list[DeviceOp]:
        """The kernels whose name matches ``pattern`` (a regex), in start order."""
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op.name)]

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations with the most summed seconds."""
        total: dict[str, int] = {}
        for op in self.ops:
            total[op.name] = total.get(op.name, 0) + op.end - op.start
        return [[name, ns / 1e9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, records: list[dict], n: int = 10) -> list[list]:
        """The ``n`` longest gaps with no device activity, each named by the
        kind of the last journal record before it (``"after dispatch"``...)."""
        gaps, reach = [], self.ns_t0
        for op in self.ops:
            if op.start > reach:
                gaps.append((reach, op.start))
            reach = max(reach, op.end)
        gaps.sort(key=lambda g: g[0] - g[1])
        stamps = sorted((self.ns_t0 + int((r["t"] - self.host_t0) * 1e9), r["kind"])
                        for r in records)
        out = []
        for start, end in gaps[:n]:
            before = [kind for t, kind in stamps if t <= start]
            out.append([f"after {before[-1]}" if before else "before the first record",
                        (end - start) / 1e9])
        return out


def _union_ns(ops: list[DeviceOp], lo: int, hi: int) -> int:
    busy, reach = 0, lo
    for op in ops:
        start, end = max(op.start, reach), min(op.end, hi)
        if end > start:
            busy += end - start
        reach = max(reach, min(op.end, hi))
    return busy


class Tracer:
    """Start and stop the profiler on one thread; ``stop`` returns the summary."""

    START, STOP = "fedbench.window.start", "fedbench.window.stop"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._host_t0 = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        with torch.profiler.record_function(self.START):
            self._host_t0 = time.time()

    def stop(self) -> TraceSummary:
        torch.cuda.synchronize()
        with torch.profiler.record_function(self.STOP):
            pass
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        marks = {e.name(): e.start_ns() for e in events if e.name() in (self.START, self.STOP)}
        lo, hi = marks[self.START], marks[self.STOP]
        ops = sorted((DeviceOp(e.name(), e.start_ns(), e.end_ns()) for e in events
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and e.end_ns() > lo and e.start_ns() < hi),
                     key=lambda op: op.start)
        copy_ns = sum(min(op.end, hi) - max(op.start, lo) for op in ops if COPY.match(op.name))
        return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=_union_ns(ops, lo, hi) / 1e9,
                            copy_s=copy_ns / 1e9, ops=ops, host_t0=self._host_t0, ns_t0=lo)
