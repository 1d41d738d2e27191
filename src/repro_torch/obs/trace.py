"""Span-based tracing with ring retention and offline exporters.

The metrics plane (``repro_torch.obs.metrics``) answers *how much / how often*;
this module answers **why was this tick slow** and **where did this
degraded reply come from**:

* :class:`Span` — a named, timed region with free-form attributes and
  point-in-time :meth:`Span.event` records.  Spans nest: the tracer
  keeps an open-span stack, children carry ``parent_id``, and events
  attach to the innermost open span — so a ``fault`` event fired inside
  a solve dispatch lands on that tick's ``stage.solve_flush`` span and a
  degraded reply is traceable to the exact injected fault that caused
  it (the CI trace-audit contract, see ``tools/tracequery.py``).
* :class:`Tracer` — ``with tracer.span("solve_flush", bucket=64):``.
  The clock is injectable; pass the same
  :class:`~repro_torch.service.resilience.InjectedClock` the broker runs on
  and every timestamp in a chaos trace is a pure deterministic function
  of the fault schedule.  Finished spans live in a bounded ring
  (``capacity`` newest are retained), so a long-lived server can keep a
  tracer attached without growing without limit.
* **Exporters** — :meth:`Tracer.export_jsonl` (one span per line; the
  format ``tools/tracequery.py`` consumes) and
  :meth:`Tracer.export_chrome` (Chrome ``trace_event`` JSON: load it in
  ``about://tracing`` / Perfetto for a flame view of broker ticks).
* **The profiler bridge** — while a ``torch.profiler`` records, each
  span also opens a ``torch.profiler.record_function`` range of its name
  for as long as it is open (and only then: a range costs ~11 µs on a CPU
  even with no profiler running).  The span then lies in the profiler's
  trace on the clock of the device's rows, so device activity and idle
  gaps can be put down to it.  The bridge looks for torch's profiler among
  the loaded modules and never imports torch.
* **The active tracer** — :meth:`Tracer.activate` makes a tracer the
  current one of the context; the module-level :func:`span` opens a span
  on it, for code that holds no handle to a tracer (the model's layer
  functions under the serving engine's step), and :func:`annotate` sets
  attributes on its innermost open span from deeper still (the route an
  attention call takes, from the branch that takes it).

With no tracer attached the instrumented paths never construct a span
(the broker's helpers return the shared :data:`NULL_SPAN`; :func:`span`
with no active tracer reads one context variable and returns it), so
detached behavior is bit-identical to the pre-observability code —
asserted by ``tests/test_observability.py`` and
``tests/test_torch_serve_trace.py``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import pathlib
import sys
import time
from collections import deque
from typing import Callable

__all__ = ["Span", "Tracer", "NULL_SPAN", "span", "annotate"]


class _NullSpan:
    """Shared no-op span: what detached/disabled call sites receive."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:  # noqa: ARG002
        return

    def event(self, name, **attrs) -> None:  # noqa: ARG002
        return


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Created by :meth:`Tracer.span`; use as a
    context manager.  ``set`` adds attributes mid-span (e.g. the number
    of representatives a flush actually solved); ``event`` records a
    timestamped point annotation on this span."""

    __slots__ = (
        "name",
        "attrs",
        "events",
        "span_id",
        "parent_id",
        "t0",
        "t1",
        "_tracer",
        "_range",
    )

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.events: list[dict] = []
        self.span_id = 0
        self.parent_id: int | None = None
        self.t0 = 0.0
        self.t1 = 0.0
        self._tracer = tracer
        self._range = None     # the profiler range the bridge opened

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs) -> None:
        self.events.append(
            {"name": name, "ts": self._tracer.clock(), "attrs": attrs}
        )

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "type": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.t0,
            "dur": self.duration,
            "attrs": self.attrs,
            "events": self.events,
        }


class Tracer:
    """Span factory + bounded ring of finished spans.

    Parameters:
      clock:    timestamp source (default ``time.perf_counter``);
                injectable for deterministic chaos traces.
      capacity: finished-span retention — the newest ``capacity`` spans
                are kept (open spans are never dropped).
      enabled:  ``False`` makes :meth:`span` return :data:`NULL_SPAN`
                and :meth:`event` a no-op (the zero-cost switch; flip
                at runtime to start/stop capturing).
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 4096,
        enabled: bool = True,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.clock = clock
        self.enabled = bool(enabled)
        self._ring: deque[Span] = deque(maxlen=int(capacity))
        self._stack: list[Span] = []
        self._next_id = 1

    # -- recording -------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a span (context manager).  Timing starts at ``__enter__``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Record a point event on the innermost open span (or as an
        orphan span of zero duration when none is open — events must
        never be silently dropped)."""
        if not self.enabled:
            return
        if self._stack:
            self._stack[-1].event(name, **attrs)
            return
        s = Span(self, name, attrs)
        s.span_id = self._next_id
        self._next_id += 1
        s.t0 = s.t1 = self.clock()
        s.attrs = dict(attrs, orphan_event=True)
        self._ring.append(s)

    def _push(self, span: Span) -> None:
        span.span_id = self._next_id
        self._next_id += 1
        span.parent_id = self._stack[-1].span_id if self._stack else None
        self._stack.append(span)
        # the profiler bridge: torch's profiler is loaded once torch is
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            span._range = prof.record_function(span.name)
            span._range.__enter__()
        span.t0 = self.clock()

    def _pop(self, span: Span) -> None:
        span.t1 = self.clock()
        # tolerate exception-skewed exits: pop through to this span
        while self._stack:
            top = self._stack.pop()
            if top._range is not None:
                top._range.__exit__(None, None, None)
                top._range = None
            if top is span:
                break
        self._ring.append(span)

    @contextlib.contextmanager
    def activate(self):
        """Make this the context's active tracer (:func:`span` opens its
        spans on it) until the block ends."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # -- introspection ---------------------------------------------------
    def spans(self, name: str | None = None) -> list[Span]:
        """Finished spans, oldest first (filtered by ``name`` if given)."""
        return [s for s in self._ring if name is None or s.name == name]

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    # -- exporters -------------------------------------------------------
    def export_jsonl(self, path) -> int:
        """One finished span per line (the ``tools/tracequery.py``
        format).  Returns the number of spans written."""
        path = pathlib.Path(path)
        with path.open("w") as f:
            for s in self._ring:
                f.write(json.dumps(s.to_dict(), default=_arg) + "\n")
        return len(self._ring)

    def export_chrome(self, path) -> int:
        """Chrome ``trace_event`` JSON for ``about://tracing`` /
        Perfetto.  Spans export as complete (``"X"``) events in µs,
        span events as instants (``"i"``) bound to the same thread
        track.  Returns the number of trace events written."""
        events: list[dict] = []
        for s in self._ring:
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": s.t0 * 1e6,
                    "dur": s.duration * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {k: _arg(v) for k, v in s.attrs.items()},
                }
            )
            for e in s.events:
                events.append(
                    {
                        "name": e["name"],
                        "ph": "i",
                        "ts": e["ts"] * 1e6,
                        "pid": 0,
                        "tid": 0,
                        "s": "t",
                        "args": {k: _arg(v) for k, v in e["attrs"].items()},
                    }
                )
        path = pathlib.Path(path)
        path.write_text(
            json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
            + "\n"
        )
        return len(events)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tracer", default=None)


def span(name: str, **attrs):
    """A span on the context's active tracer; :data:`NULL_SPAN` when none
    is active (no span is built and no clock is read)."""
    tracer = _ACTIVE.get()
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **attrs)


def annotate(name: str, **attrs) -> None:
    """Set ``attrs`` on the active tracer's innermost open span if that
    span is named ``name``; nothing otherwise, or with no active tracer."""
    tracer = _ACTIVE.get()
    if tracer is not None and tracer._stack and tracer._stack[-1].name == name:
        tracer._stack[-1].attrs.update(attrs)


def _arg(v):
    """Chrome args must be JSON-serializable; stringify anything exotic."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)
