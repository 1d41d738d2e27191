"""Process-local metrics plane: counters, gauges, quantile histograms.

Until now the serving tier's only observability was the ad-hoc integer
counters on :class:`~repro_torch.service.broker.BrokerTelemetry` — totals with
no distribution, no per-stage attribution, and no way to aggregate
across future solver workers.  This module is the metrics half of the
telemetry plane (``repro_torch.obs.trace`` is the tracing half):

* :class:`Counter` / :class:`Gauge` — monotonic totals and last-value
  instruments, keyed by (name, sorted label items).
* :class:`Histogram` — **fixed-bucket log-scale** value distribution:
  bucket edges form a geometric series, so relative resolution is
  constant at every magnitude (the right shape for latencies spanning
  µs solver dispatches to second-long fault-storm ticks).  Quantiles
  (:meth:`Histogram.quantile`, ``p50``/``p90``/``p99``) interpolate
  geometrically inside the winning bucket; exact ``sum``/``count``/
  ``min``/``max`` ride along.
* **Mergeable** — two histograms (or whole registries) with the same
  bucket geometry merge by adding count vectors
  (:meth:`Histogram.merge`, :meth:`MetricsRegistry.merge`), the
  property the future multi-process solver fleet needs: workers ship
  snapshots, the management plane merges, quantiles stay correct.
* **Near-zero when disabled** — ``MetricsRegistry(enabled=False)``
  hands out shared null instruments whose methods are constant-time
  no-ops, so instrumented hot paths cost a dict lookup at bind time and
  nothing per event; with no registry *attached* the instrumented code
  paths are not merely cheap but bit-identical to the pre-observability
  behavior (asserted by ``tests/test_observability.py``).

Everything is plain Python + stdlib ``array`` — importable before torch,
usable from tools, and cheap to snapshot as JSON.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments are errors."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._value += amount

    def merge(self, other: "Counter") -> None:
        self._value += other._value


class Gauge:
    """Last-value instrument (queue depths, deficits, cache sizes)."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def set(self, value: float) -> None:
        self._value = float(value)

    def add(self, amount: float) -> None:
        self._value += amount

    def merge(self, other: "Gauge") -> None:
        # cross-worker gauges are additive by convention (queue depths,
        # cache sizes); a last-write-wins gauge should not be merged
        self._value += other._value


class Histogram:
    """Fixed-bucket log-scale histogram with quantile estimation.

    Bucket ``i`` (0-based) covers ``[lo·growth^i, lo·growth^(i+1))``;
    values below ``lo`` land in a dedicated underflow bucket, values at
    or above the top edge in an overflow bucket.  With the default
    geometry (``lo=1e-6``, ``growth=2``, 36 buckets) the range spans
    1 µs … ~68 s at a constant 2× relative resolution — wide enough for
    both a solver dispatch and a fault-storm tick.

    Quantiles interpolate geometrically within the winning bucket (the
    natural interpolation for a log-scale bucket), clamped to the exact
    observed ``min``/``max`` so a single-sample histogram reports that
    sample at every quantile.
    """

    __slots__ = (
        "name",
        "labels",
        "lo",
        "growth",
        "counts",
        "underflow",
        "overflow",
        "count",
        "sum",
        "min",
        "max",
    )

    DEFAULT_LO = 1e-6
    DEFAULT_GROWTH = 2.0
    DEFAULT_BUCKETS = 36

    def __init__(
        self,
        name: str,
        labels: dict | None = None,
        *,
        lo: float = DEFAULT_LO,
        growth: float = DEFAULT_GROWTH,
        n_buckets: int = DEFAULT_BUCKETS,
    ):
        if lo <= 0:
            raise ValueError("lo must be positive")
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        if n_buckets <= 0:
            raise ValueError("n_buckets must be positive")
        self.name = name
        self.labels = dict(labels or {})
        self.lo = float(lo)
        self.growth = float(growth)
        self.counts = [0] * int(n_buckets)
        self.underflow = 0
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording -------------------------------------------------------
    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value < self.lo:
            self.underflow += 1
            return
        i = int(math.log(value / self.lo) / math.log(self.growth))
        if i >= len(self.counts):
            self.overflow += 1
        else:
            self.counts[i] += 1

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    # -- quantiles -------------------------------------------------------
    def _edge(self, i: int) -> float:
        return self.lo * self.growth**i

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 ≤ q ≤ 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = self.underflow
        if rank <= seen:
            # underflow bucket: everything below lo; report observed min
            return max(self.min, 0.0)
        value = self.max
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if rank <= seen + c:
                frac = (rank - seen) / c
                # geometric interpolation inside the log-scale bucket
                value = self._edge(i) * self.growth**frac
                break
            seen += c
        # overflow (or interpolation past the data): clamp to observations
        return min(max(value, self.min), self.max)

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p90(self) -> float:
        return self.quantile(0.90)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -- merging ---------------------------------------------------------
    def compatible(self, other: "Histogram") -> bool:
        return (
            math.isclose(self.lo, other.lo)
            and math.isclose(self.growth, other.growth)
            and len(self.counts) == len(other.counts)
        )

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s observations in (same bucket geometry only)."""
        if not self.compatible(other):
            raise ValueError(
                f"histogram {self.name!r}: incompatible bucket geometry"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.underflow += other.underflow
        self.overflow += other.overflow
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


class _NullCounter(Counter):
    """Shared no-op counter: the disabled registry's hand-out."""

    def inc(self, amount: float = 1.0) -> None:  # noqa: ARG002
        return


class _NullGauge(Gauge):
    def set(self, value: float) -> None:  # noqa: ARG002
        return

    def add(self, amount: float) -> None:  # noqa: ARG002
        return


class _NullHistogram(Histogram):
    def observe(self, value: float) -> None:  # noqa: ARG002
        return

    def observe_many(self, values) -> None:  # noqa: ARG002
        return


NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram("null")


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _Timer:
    """Context manager charging elapsed clock time to a histogram."""

    __slots__ = ("_hist", "_clock", "_t0")

    def __init__(self, hist: Histogram, clock: Callable[[], float]):
        self._hist = hist
        self._clock = clock

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self._hist.observe(self._clock() - self._t0)
        return False


class MetricsRegistry:
    """Get-or-create instrument store, keyed by (name, sorted labels).

    Parameters:
      enabled: ``False`` hands out shared null instruments — every
               instrumented call site stays wired but records nothing
               (the overhead smoke gate measures this mode).
      clock:   timer clock (:meth:`timer`); injectable — pass the same
               :class:`~repro_torch.service.resilience.InjectedClock` the
               broker runs on and timing histograms become a pure
               function of the fault schedule.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.enabled = bool(enabled)
        self.clock = clock
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    # -- instrument accessors (get-or-create) ----------------------------
    def counter(self, name: str, **labels) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter(name, labels)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge(name, labels)
        return g

    def histogram(
        self,
        name: str,
        *,
        lo: float = Histogram.DEFAULT_LO,
        growth: float = Histogram.DEFAULT_GROWTH,
        n_buckets: int = Histogram.DEFAULT_BUCKETS,
        **labels,
    ) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(
                name, labels, lo=lo, growth=growth, n_buckets=n_buckets
            )
        return h

    def timer(self, name: str, **labels):
        """``with registry.timer("solve_envs_duration_s", backend=...):``
        — observes elapsed ``clock`` seconds into the named histogram."""
        if not self.enabled:
            return _NULL_TIMER
        return _Timer(self.histogram(name, **labels), self.clock)

    # -- export / merge --------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable export of every instrument (the wire format
        a worker would ship to the management plane)."""

        def label_dict(key: tuple) -> dict:
            return dict(key[1])

        return {
            "counters": [
                {"name": k[0], "labels": label_dict(k), "value": c.value}
                for k, c in sorted(self._counters.items())
            ],
            "gauges": [
                {"name": k[0], "labels": label_dict(k), "value": g.value}
                for k, g in sorted(self._gauges.items())
            ],
            "histograms": [
                {
                    "name": k[0],
                    "labels": label_dict(k),
                    "lo": h.lo,
                    "growth": h.growth,
                    "counts": list(h.counts),
                    "underflow": h.underflow,
                    "overflow": h.overflow,
                    "count": h.count,
                    "sum": h.sum,
                    "min": None if h.count == 0 else h.min,
                    "max": None if h.count == 0 else h.max,
                    "p50": h.p50,
                    "p90": h.p90,
                    "p99": h.p99,
                }
                for k, h in sorted(self._histograms.items())
            ],
        }

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (counters add, gauges add, histograms
        merge bucket-wise) — the fleet-aggregation path."""
        for key, c in other._counters.items():
            mine = self._counters.get(key)
            if mine is None:
                mine = self._counters[key] = Counter(c.name, c.labels)
            mine.merge(c)
        for key, g in other._gauges.items():
            mine = self._gauges.get(key)
            if mine is None:
                mine = self._gauges[key] = Gauge(g.name, g.labels)
            mine.merge(g)
        for key, h in other._histograms.items():
            mine = self._histograms.get(key)
            if mine is None:
                mine = self._histograms[key] = Histogram(
                    h.name, h.labels, lo=h.lo, growth=h.growth,
                    n_buckets=len(h.counts),
                )
            mine.merge(h)

    @classmethod
    def from_snapshot(cls, doc: dict, *, clock=None) -> "MetricsRegistry":
        """Rehydrate a registry from :meth:`snapshot`'s wire format.

        The inverse half of the cross-process telemetry path: a
        :class:`~repro_torch.service.server.SolverServer` ships
        ``snapshot()`` inside a ``telemetry_report`` frame and the
        client rebuilds live instruments from it — ready to
        :meth:`merge` into a fleet-wide registry.  Malformed entries
        are skipped (telemetry must never crash the consumer);
        histogram quantiles are re-derived from the bucket counts, not
        trusted from the document.
        """
        reg = cls(enabled=True, **({"clock": clock} if clock else {}))
        for e in doc.get("counters", ()):
            try:
                reg.counter(e["name"], **e.get("labels", {})).inc(
                    float(e["value"])
                )
            except (KeyError, TypeError, ValueError):
                continue
        for e in doc.get("gauges", ()):
            try:
                reg.gauge(e["name"], **e.get("labels", {})).set(
                    float(e["value"])
                )
            except (KeyError, TypeError, ValueError):
                continue
        for e in doc.get("histograms", ()):
            try:
                h = reg.histogram(
                    e["name"],
                    lo=float(e["lo"]),
                    growth=float(e["growth"]),
                    n_buckets=len(e["counts"]),
                    **e.get("labels", {}),
                )
                h.counts = [int(c) for c in e["counts"]]
                h.underflow = int(e["underflow"])
                h.overflow = int(e["overflow"])
                h.count = int(e["count"])
                h.sum = float(e["sum"])
                h.min = math.inf if e.get("min") is None else float(e["min"])
                h.max = -math.inf if e.get("max") is None else float(e["max"])
            except (KeyError, TypeError, ValueError):
                continue
        return reg

    # -- introspection ---------------------------------------------------
    def get_counter(self, name: str, **labels) -> Counter | None:
        return self._counters.get((name, _label_key(labels)))

    def get_gauge(self, name: str, **labels) -> Gauge | None:
        return self._gauges.get((name, _label_key(labels)))

    def get_histogram(self, name: str, **labels) -> Histogram | None:
        return self._histograms.get((name, _label_key(labels)))

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Counter-or-gauge value by name (0.0 / ``default`` if absent)."""
        c = self.get_counter(name, **labels)
        if c is not None:
            return c.value
        g = self.get_gauge(name, **labels)
        if g is not None:
            return g.value
        return default
