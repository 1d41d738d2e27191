"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA
activity) over the first ``units`` units of the window, inside one host
range (``trace.WINDOW_SPAN``), with the program's launch counters read
over the same units.  Off, it costs nothing."""

from __future__ import annotations

import contextlib

import torch

from bench.harness import program, trace


class Tracer:
    def __init__(self, enabled: bool, units: int, kernels, device):
        self.enabled = enabled and units > 0
        self.units = units
        self.kernels = list(kernels)
        self.device = device
        self.summary = None       # trace.TraceSummary once traced
        self.counted = None       # launches by kernel over the traced units
        self.done = False
        self._stack = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._stack is not None

    def before_unit(self) -> None:
        if not self.enabled or self.done or self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        program.sync(self.device)
        program.reset_counters(self.kernels)
        self._stack = contextlib.ExitStack()
        self._prof = self._stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(torch.profiler.record_function(trace.WINDOW_SPAN))

    def after_unit(self, index_in_trace: int) -> bool:
        """Close the trace after its last unit; True if this unit was traced."""
        if not self.active:
            return False
        if index_in_trace + 1 >= self.units:
            program.sync(self.device)
            self.counted = program.read_counters(self.kernels)
            self._stack.close()
            self._stack = None
            self.done = True
        return True

    def finish(self) -> None:
        """Reduce the trace (after the window: the reduction is host work)."""
        if self._prof is not None:
            events = trace.events_of(self._prof)
            self.summary = trace.reduce(events, *trace.window_bounds(events))
            self._prof = None
