"""Observability plane: metrics registry + span tracing + exporters.

``metrics`` — :class:`MetricsRegistry`: counters, gauges and mergeable
              log-scale quantile histograms (p50/p90/p99), near-zero
              cost when disabled and snapshot/merge-able across the
              future solver-worker fleet.
``trace``   — :class:`Tracer`: per-tick stage spans with an injectable
              clock, bounded ring retention, and exporters to JSONL
              (``tools/tracequery.py``) and Chrome ``trace_event``
              format (``about://tracing``).

Both halves are strictly opt-in: a broker or session tick with no
tracer/registry attached runs bit-identically to the pre-observability
code (asserted by ``tests/test_observability.py``).  See
``docs/OBSERVABILITY.md`` for the metric catalog and span taxonomy.
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
    "NULL_SPAN",
    "Span",
    "Tracer",
]
