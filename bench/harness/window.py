"""The measured window: work over time on the host's clock.

A window opens at ``start()`` and takes units of work (a training step, an
engine step) as they end.  It closes at the end of the first unit that
ends at least ``seconds`` after the start and leaves the system idle (for
serving: no request in flight), so every unit is counted whole and the
rate is the work of every unit over the whole time, stalls included."""

from __future__ import annotations

import time


class Window:
    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = seconds
        self.clock = clock
        self.t_start = self.t_end = None
        self.units: list[tuple[float, float]] = []   # (start, end) of each unit
        self.work = 0.0

    def start(self) -> None:
        self.t_start = self.clock()

    def unit_start(self) -> float:
        return self.clock()

    def unit_end(self, t_unit_start: float, work: float = 0.0, *, idle: bool = True) -> bool:
        """Record a unit that began at ``t_unit_start`` and did ``work``;
        returns True when the window has closed with it."""
        now = self.clock()
        self.units.append((t_unit_start, now))
        self.work += work
        if now - self.t_start >= self.seconds and idle:
            self.t_end = now
            return True
        return False

    def add_work(self, work: float) -> None:
        """Work that completes with the current unit (counted in the rate)."""
        self.work += work

    @property
    def elapsed(self) -> float:
        return (self.t_end if self.t_end is not None else self.clock()) - self.t_start

    def rate(self) -> float:
        """All the window's work over all its seconds."""
        return self.work / self.elapsed
