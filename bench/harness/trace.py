"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activity) runs over the first units of the
window in a ``--trace 1`` run.  Its events are reduced to

* the device's activity intervals (kernels, copies and sets) and their
  union: ``busy_s`` is the union's length, so overlapping work is counted
  once, and the idle share is ``1 - busy_s / window_s``;
* kernel time by name, and by family (B4, B5, their backward kernels,
  matrix products, the rest), as ``chip_smoke.py:kernel_time_by_group``
  groups it;
* the gaps between device activity, each named by the innermost host
  operation running at its midpoint.
"""

from __future__ import annotations

import dataclasses

# A device row of the profiler is a kernel, a copy or set, or no device
# activity: the ranges of the host's annotations (``record_function``) and
# the host waiting on a full launch queue are drawn on the device's row too.
COPY_NAMES = ("Memcpy", "Memset")
NOT_ACTIVITY = ("Command Buffer Full",)
MATMUL_MARKS = ("gemm", "cutlass", "nvjet", "sm90_xmma", "cublas")


@dataclasses.dataclass
class Event:
    name: str
    kind: str         # "kernel", "copy", "host" or "other"
    start: float      # seconds
    end: float


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict            # kernel name -> seconds
    copy_s: float
    gaps: list                # (seconds, host op) of each idle gap

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name ``match(name)`` accepts."""
        return sum(s for n, s in self.kernel_s.items() if match(n))

    def top_kernels(self, k: int = 10) -> list:
        return sorted(([n, s] for n, s in self.kernel_s.items()), key=lambda e: -e[1])[:k]

    def top_gaps(self, k: int = 10) -> list:
        """The host operations under which the device idled longest, with
        the idle seconds summed by operation."""
        by_op: dict = {}
        for s, op in self.gaps:
            by_op[op] = by_op.get(op, 0.0) + s
        return sorted(([op, s] for op, s in by_op.items()), key=lambda e: -e[1])[:k]


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(mark in low for mark in MATMUL_MARKS)


def _union(intervals: list) -> tuple[float, list]:
    """Length of the union of ``(start, end)`` intervals, and the gaps
    between its pieces."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def name_gaps(host: list[Event], gaps: list) -> list:
    """``(seconds, name)`` of each ``(start, end)`` gap: the innermost host
    event open at its midpoint (the latest started that has not ended), in
    one sweep over the events in start order with a stack of open ones."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for a, b in sorted(gaps):
        t = (a + b) / 2
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append((b - a, stack[-1].name if stack else "(no host op)"))
    return out


WINDOW_SPAN = "bench.traced_window"


def window_bounds(events: list[Event]) -> tuple[float, float]:
    """Start and end of the benchmark's ``WINDOW_SPAN`` host range, which
    encloses the traced units (in the trace's own clock)."""
    span = next(e for e in events if e.kind == "host" and e.name == WINDOW_SPAN)
    return span.start, span.end


def reduce(events: list[Event], t0: float, t1: float) -> TraceSummary:
    """The summary of ``events`` within the window ``[t0, t1]`` (seconds)."""
    device = [e for e in events if e.kind in ("kernel", "copy") and e.end > t0 and e.start < t1]
    busy, gaps = _union([(max(e.start, t0), min(e.end, t1)) for e in device])
    if device:
        first = min(e.start for e in device)
        last = max(e.end for e in device)
        gaps = [(t0, first)] * (first > t0) + gaps + [(last, t1)] * (last < t1)
    else:
        gaps = [(t0, t1)]
    kernel_s: dict = {}
    copy_s = 0.0
    for e in device:
        if e.kind == "copy":
            copy_s += e.end - e.start
        else:
            kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.end - e.start)
    named = name_gaps([e for e in events if e.kind == "host"], [g for g in gaps if g[1] > g[0]])
    return TraceSummary(window_s=t1 - t0, busy_s=busy, kernel_s=kernel_s, copy_s=copy_s,
                        gaps=named)


def device_kind(name: str, annotations) -> str:
    """``"kernel"``, ``"copy"`` or ``"other"`` of a device row, by its name."""
    if name in annotations or name in NOT_ACTIVITY:
        return "other"
    return "copy" if name.startswith(COPY_NAMES) else "kernel"


def events_of(prof) -> list[Event]:
    """The kineto events of a finished ``torch.profiler.profile``."""
    out, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        ev = Event(e.name(), "host", start, start + e.duration_ns() / 1e9)
        (device if "CUDA" in str(e.device_type()) else out).append(ev)
    # a host range's name on the device row is its annotation, no activity
    annotations = {e.name for e in out} | {WINDOW_SPAN}
    for ev in device:
        ev.kind = device_kind(ev.name, annotations)
    return out + device
