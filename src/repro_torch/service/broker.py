"""OffloadBroker — async multi-tenant partition service (serving tier).

The paper's adaptive loop (Fig. 1) is per-user: profile once, monitor
the environment, re-partition on drift.  At serving scale millions of
users run the *same* profiled applications through a handful of
recurring environment regimes, so solving each repartition point
one-at-a-time wastes both dispatches and solutions.  The broker is the
subsystem that turns the batched throughput primitives
(:func:`repro_torch.core.mcop.mcop_batch`,
:class:`repro_torch.core.placement_cache.PlacementCache`) into a long-lived
service:

* **Tenants** — one registered (profile, cost model) pair per served
  application, each with its own shared
  :class:`~repro_torch.core.placement_cache.PlacementCache` guarded by a
  :func:`~repro_torch.core.placement_cache.profile_fingerprint`.
* **Async submit** — per-user controllers
  (:class:`repro_torch.service.session.BrokerSession` wrapping
  :class:`~repro_torch.core.adaptive.AdaptiveController`) and elastic events
  (an elastic mesh manager's resize submissions, ``lane="elastic"``)
  enqueue solve requests and get a :class:`PlacementFuture` back.
* **Coalescing tick** — :meth:`OffloadBroker.tick` drains the queue,
  serves cache hits immediately, coalesces remaining requests by
  (tenant, quantized-environment-bin) down to one representative solve
  per bin, and flushes all representatives through **one**
  ``mcop_batch`` call per static shape bucket.  Followers and hits are
  repriced under their *exact* request graph (same honesty contract as
  the controller), so a tick costs O(distinct bins), not O(requests).
* **Array-native flush** — :meth:`submit` no longer builds a WCG per
  request: construction is deferred to the tick, where each tenant's
  pending environments are built in ONE vectorized
  ``cost_model.build_batch`` call (rows bit-identical to the scalar
  ``build``), and each bucket's representatives are packed into a
  :class:`~repro_torch.core.graph.WCGBatch` that ``mcop_batch`` dispatches
  directly — no per-request Python graph objects on the hot path.
* **Fused tick pricing** — every reply a tick produces (cache hits,
  representative clamps, coalesced followers) is priced in one
  vectorized :meth:`~repro_torch.core.graph.WCGBatch.price_batch` evaluation
  per graph size instead of a scalar ``reprice_clamped`` per future;
  replies are bit-identical to the serial per-future path (unpadded
  pricing batches, see ``repro_torch.core.pricing``).
* **Weighted-fair scheduling** — the flush order is a
  :class:`~repro_torch.service.scheduler.WeightedFairScheduler`: elastic
  resize events (``lane="elastic"``) remain a strict priority lane (a shrinking fleet
  must re-place before any user refresh is served a placement solved
  for capacity that no longer exists), and user-lane requests drain by
  deficit round robin over per-tenant weights (``register(...,
  weight=)``), so a chatty tenant cannot starve a light one when
  :meth:`tick` runs with a ``budget``.  Backpressure: past
  ``max_queued_bins`` distinct queued (tenant, bin) pairs, a submission
  opening a new bin is rejected — its future resolves immediately with
  a :attr:`BrokerReply.rejected` reply.  Lane occupancy, per-tenant
  shares and rejections are telemetered per tick
  (:attr:`TickReport.elastic` / :attr:`TickReport.shares` /
  :attr:`TickReport.rejected`).
* **Batched session groups** — :meth:`OffloadBroker.register_batch`
  attaches a :class:`~repro_torch.service.session.BatchSessionGroup`: K
  sessions of a tenant held as ONE
  :class:`~repro_torch.core.session_batch.SessionBatch`, observed as
  arrays and resolved per tick by one vectorized
  :func:`~repro_torch.core.session_batch.tick_sessions` call against the
  tenant's shared cache — the 10⁵–10⁶-concurrent-user path, with events
  bit-identical to the per-object sessions above.  Group service
  latency feeds the scheduler's optional load-adaptive weights
  (``register(..., adaptive_weight=True)``).
* **Fault tolerance** (opt-in) — constructed with a
  :class:`~repro_torch.service.resilience.ResiliencePolicy` (and optionally a
  seeded :class:`~repro_torch.service.faults.FaultInjector` for chaos
  testing), the tick becomes a failure domain per (bin, bucket): solver
  dispatches retry with exponential backoff under a per-backend circuit
  breaker (cuda → torch → reference for solves on the CPU; on a GPU the
  backend never changes), a flush that exhausts its retries
  quarantines ONLY its own bucket's requests — served a *fallback
  placement* (stale cached bin if available, else the paper's §4.3
  no-offload plan) marked :attr:`BrokerReply.degraded`, or re-queued —
  while healthy buckets commit normally; per-request deadlines resolve
  overdue queued futures as :attr:`BrokerReply.timed_out`; and
  :meth:`OffloadBroker.drain` resolves abandoned futures at shutdown
  instead of stranding them.  With ``resilience=None`` (default) the
  legacy contract is preserved bit-identically: failures re-queue
  unresolved requests and re-raise.  A
  :class:`~repro_torch.kernels.build.KernelError` (no device, failed
  build, refused launch) is outside every failure domain: no policy
  retries, counts or degrades it, it leaves :meth:`OffloadBroker.tick`.
* **Persistence** — tenant caches snapshot/load as JSON
  (:meth:`OffloadBroker.snapshot` / ``warm_start=`` on
  :meth:`OffloadBroker.register`), so a serving restart replays a known
  workload with *zero* solver dispatches.
* **Telemetry** — per-tick latency, queue depth, coalesce ratio and
  cache hit rate (:class:`BrokerTelemetry`), the numbers a deployment
  would alert on.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.cost_models import AppProfile, CostModel, Environment
from repro_torch.core.graph import WCG, WCGBatch
from repro_torch.core.mcop import (
    DEFAULT_BUCKETS,
    MCOPResult,
    _bucket_size,
    _single_device,
    mcop_batch,
)
from repro_torch.core.placement_cache import (
    EnvQuantizer,
    PlacementCache,
    profile_fingerprint,
)
from repro_torch.kernels.build import KernelError
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.service.faults import FaultInjector, InjectedFault, poison_batch
from repro_torch.service.resilience import ResiliencePolicy
from repro_torch.service.scheduler import QueueEntry, WeightedFairScheduler

__all__ = [
    "PlacementFuture",
    "BrokerReply",
    "TickReport",
    "BrokerTelemetry",
    "OffloadBroker",
]


@dataclasses.dataclass(frozen=True)
class BrokerReply:
    """What a resolved :class:`PlacementFuture` carries.

    ``result`` is clamped (paper §4.3) and priced under the requester's
    exact WCG — identical to what a serial
    :meth:`~repro_torch.core.adaptive.AdaptiveController.observe` would have
    produced.  ``cache_hit`` mirrors the controller's event flag
    (coalesced followers count as hits: the serial loop would have hit
    the representative's just-stored mask).  ``coalesced`` additionally
    distinguishes same-tick followers from genuine cache hits.

    ``rejected`` marks a backpressure rejection (the scheduler's queued
    -bin cap was reached); a rejected reply carries ``result=None`` and
    resolves at submit time, so callers can retry a later tick without
    waiting.  A broker shutdown (:meth:`OffloadBroker.drain`) also
    resolves abandoned futures as rejected.

    ``degraded`` marks a graceful-degradation reply (resilient brokers
    only): the solve exhausted its retries, so ``result`` is a *fallback
    placement* — the stale cached bin if one existed, else the paper's
    §4.3 no-offload plan — always valid, possibly not optimal.

    ``timed_out`` marks a deadline expiry: the request was still queued
    past its deadline tick and carries ``result=None``.
    """

    result: MCOPResult | None
    cache_hit: bool
    coalesced: bool
    tick: int
    rejected: bool = False
    degraded: bool = False
    timed_out: bool = False


class PlacementFuture:
    """Minimal single-assignment future resolved by :meth:`OffloadBroker.tick`.

    Deliberately not ``asyncio`` — the broker is deterministic and
    tick-driven, so waiters poll :attr:`done` after a tick rather than
    suspend on an event loop.
    """

    __slots__ = ("_reply",)

    def __init__(self) -> None:
        self._reply: BrokerReply | None = None

    @property
    def done(self) -> bool:
        return self._reply is not None

    def set(self, reply: BrokerReply) -> None:
        if self._reply is not None:
            raise RuntimeError("future already resolved")
        self._reply = reply

    @property
    def result(self) -> BrokerReply:
        if self._reply is None:
            raise RuntimeError("future not resolved yet; run broker.tick()")
        return self._reply


@dataclasses.dataclass(frozen=True)
class TickReport:
    """One tick's telemetry snapshot."""

    tick: int
    queue_depth: int        # requests waiting when the tick started
    requests: int           # requests drained this tick (== queue_depth
                            # unless the tick ran with a budget)
    cache_hits: int         # served from a tenant cache, no solve
    coalesced: int          # same-bin followers folded into another solve
    solved: int             # representative solves actually dispatched
    dispatches: int         # mcop_batch calls (≤ one per shape bucket)
    buckets: tuple[int, ...]  # bucket sizes dispatched this tick
    latency_s: float        # wall time of the tick under the broker clock
    elastic: int = 0        # priority-lane occupancy: elastic events drained
    rejected: int = 0       # backpressure rejections since the last tick
    shares: tuple[tuple[str, int], ...] = ()  # per-tenant requests drained
                            # this tick (name-sorted) — the WFQ split
    batch_groups: int = 0   # session batch groups ticked
    batch_sessions: int = 0  # active batched sessions observed this tick
    batch_hits: int = 0     # batched due-sessions served from cache
    batch_solved: int = 0   # representative solves for batched sessions
    # fault-tolerance counters (resilient brokers; all zero otherwise)
    faults: int = 0         # injected/observed fault events this tick
    retries: int = 0        # dispatch retries performed this tick
    breaker_trips: int = 0  # circuit-breaker open transitions this tick
    degraded: int = 0       # fallback-placement replies this tick
    timed_out: int = 0      # futures resolved as timed-out this tick


# TickReport field → BrokerTelemetry aggregate attribute (they differ in
# a few names); used to seed registry views from pre-bind history
_TEL_FIELD = {
    "requests": "requests",
    "cache_hits": "cache_hits",
    "coalesced": "coalesced",
    "solved": "solved",
    "dispatches": "dispatches",
    "elastic": "elastic_requests",
    "rejected": "rejected_requests",
    "batch_sessions": "batch_sessions",
    "batch_solved": "batch_solved",
    "faults": "faults",
    "retries": "retries",
    "breaker_trips": "breaker_trips",
    "degraded": "degraded_replies",
    "timed_out": "timed_out_requests",
}


@dataclasses.dataclass
class BrokerTelemetry:
    """Aggregated across ticks; ``reports`` keeps a bounded recent window."""

    ticks: int = 0
    requests: int = 0
    cache_hits: int = 0
    coalesced: int = 0
    solved: int = 0
    dispatches: int = 0
    elastic_requests: int = 0
    rejected_requests: int = 0
    batch_sessions: int = 0
    batch_solved: int = 0
    faults: int = 0
    retries: int = 0
    breaker_trips: int = 0
    degraded_replies: int = 0
    timed_out_requests: int = 0
    max_queue_depth: int = 0
    total_latency_s: float = 0.0
    reports: list[TickReport] = dataclasses.field(default_factory=list)
    keep_reports: int = 256
    # export plane (None = legacy standalone counters).  Once bound, every
    # legacy field is a view over a registry counter: record() increments
    # both from the same TickReport, so `telemetry.requests` and
    # `registry.value("broker_requests")` can never disagree (asserted by
    # tests/test_observability.py), and the registry additionally carries
    # the tick-latency histogram the plain fields never had.
    metrics: "MetricsRegistry | None" = None

    # TickReport field → registry counter, the mirrored-view schema
    _COUNTER_VIEWS = (
        ("requests", "broker_requests"),
        ("cache_hits", "broker_cache_hits"),
        ("coalesced", "broker_coalesced"),
        ("solved", "broker_solved"),
        ("dispatches", "broker_dispatches"),
        ("elastic", "broker_elastic_requests"),
        ("rejected", "broker_rejected_requests"),
        ("batch_sessions", "broker_batch_sessions"),
        ("batch_solved", "broker_batch_solved"),
        ("faults", "broker_faults"),
        ("retries", "broker_retries"),
        ("breaker_trips", "broker_breaker_trips"),
        ("degraded", "broker_degraded_replies"),
        ("timed_out", "broker_timed_out_requests"),
    )

    def bind_metrics(self, registry: "MetricsRegistry") -> None:
        """Attach the export plane; counters/histograms mirror every
        subsequent :meth:`record` (pre-bind history is seeded so views
        stay equal to the legacy fields)."""
        self.metrics = registry
        registry.counter("broker_ticks").inc(self.ticks)
        for field, counter in self._COUNTER_VIEWS:
            total = getattr(self, _TEL_FIELD[field])
            if total:
                registry.counter(counter).inc(total)

    def tick_latency_quantiles(self) -> tuple[float, float, float]:
        """(p50, p90, p99) tick latency from the bound registry histogram
        (zeros while unbound or before the first tick)."""
        if self.metrics is None:
            return (0.0, 0.0, 0.0)
        h = self.metrics.get_histogram("broker_tick_latency_s")
        if h is None:
            return (0.0, 0.0, 0.0)
        return (h.p50, h.p90, h.p99)

    def _bound_instruments(self):
        """Resolve (and cache) the mirrored instruments: the per-tick
        hot path must not pay a registry lookup per counter."""
        b = self.__dict__.get("_instr")
        if b is None or b[0] is not self.metrics:
            reg = self.metrics
            b = (
                reg,
                reg.counter("broker_ticks"),
                tuple(
                    (field, reg.counter(c)) for field, c in self._COUNTER_VIEWS
                ),
                reg.histogram("broker_tick_latency_s"),
            )
            self.__dict__["_instr"] = b
        return b

    def record(self, report: TickReport) -> None:
        if self.metrics is not None:
            _, ticks_c, views, latency_h = self._bound_instruments()
            ticks_c.inc()
            for field, counter in views:
                v = getattr(report, field)
                if v:
                    counter.inc(v)
            latency_h.observe(report.latency_s)
        self.ticks += 1
        self.requests += report.requests
        self.cache_hits += report.cache_hits
        self.coalesced += report.coalesced
        self.solved += report.solved
        self.dispatches += report.dispatches
        self.elastic_requests += report.elastic
        self.rejected_requests += report.rejected
        self.batch_sessions += report.batch_sessions
        self.batch_solved += report.batch_solved
        self.faults += report.faults
        self.retries += report.retries
        self.breaker_trips += report.breaker_trips
        self.degraded_replies += report.degraded
        self.timed_out_requests += report.timed_out
        self.max_queue_depth = max(self.max_queue_depth, report.queue_depth)
        self.total_latency_s += report.latency_s
        self.reports.append(report)
        del self.reports[: -self.keep_reports]

    @property
    def coalesce_ratio(self) -> float:
        """Fraction of requests that did NOT need their own solve."""
        return 1.0 - self.solved / self.requests if self.requests else 0.0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.requests if self.requests else 0.0

    @property
    def mean_tick_latency_s(self) -> float:
        return self.total_latency_s / self.ticks if self.ticks else 0.0

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "requests": self.requests,
            "cache_hits": self.cache_hits,
            "coalesced": self.coalesced,
            "solved": self.solved,
            "dispatches": self.dispatches,
            "elastic_requests": self.elastic_requests,
            "rejected_requests": self.rejected_requests,
            "batch_sessions": self.batch_sessions,
            "batch_solved": self.batch_solved,
            "faults": self.faults,
            "retries": self.retries,
            "breaker_trips": self.breaker_trips,
            "degraded_replies": self.degraded_replies,
            "timed_out_requests": self.timed_out_requests,
            "max_queue_depth": self.max_queue_depth,
            "coalesce_ratio": round(self.coalesce_ratio, 4),
            "hit_rate": round(self.hit_rate, 4),
            "mean_tick_latency_s": self.mean_tick_latency_s,
        }


@dataclasses.dataclass
class _Tenant:
    name: str
    profile: AppProfile | None
    cost_model: CostModel | None
    cache: PlacementCache
    fingerprint: str | None
    weight: float = 1.0


@dataclasses.dataclass
class _Request:
    tenant: _Tenant
    g: WCG | None               # None = deferred: built at tick time from env
    key: tuple[int, ...]
    future: PlacementFuture
    env: Environment | None = None
    lane: str = "user"
    expires: int | None = None  # absolute tick deadline (None = no deadline)

    @property
    def n(self) -> int:
        """Graph size of this request (profile size while deferred)."""
        return self.g.n if self.g is not None else self.tenant.profile.n


@dataclasses.dataclass
class _TickCtx:
    """One tick's fault/resilience scratchpad (resilient brokers only)."""

    injector: FaultInjector | None
    policy: ResiliencePolicy | None
    sleep: Callable[[float], None]
    entry_of: dict[int, QueueEntry] = dataclasses.field(default_factory=dict)
    solve_seq: int = 0          # per-tick dispatch-attempt counter ("solve" site)
    price_seq: int = 0          # per-tick pricing-attempt counter ("pricing" site)
    faults: int = 0
    retries: int = 0
    breaker_trips: int = 0
    degraded: int = 0

    @property
    def attempts(self) -> int:
        return self.policy.retry.attempts if self.policy is not None else 1


class OffloadBroker:
    """Coalescing tick-driven front end over the batched MCOP engine.

    Parameters:
      backend:  MCOP batch backend for the solves ("cuda", "torch",
                "reference" — the latter loops the numpy oracle, used by
                parity tests).
      device:   where the device backends run, threaded through to every
                solve this broker dispatches.  The default needs a GPU
                and raises at the first solve without one; the reference
                backend never touches it.
      buckets:  static shape buckets; each tick issues at most one
                ``mcop_batch`` call per bucket, shared across tenants.
      clock:    injectable monotonic clock for tick-latency telemetry
                (tests pass a fake clock so reports are deterministic).
      max_queued_bins: backpressure cap on distinct queued user-lane
                (tenant, bin) pairs; a submission opening a new bin past
                the cap gets an immediately-resolved rejection future
                (``None`` disables rejection — the default, matching the
                historical unbounded queue).
      resilience: optional
                :class:`~repro_torch.service.resilience.ResiliencePolicy` —
                retry/backoff on failing dispatches, per-backend circuit
                breaker, per-request deadlines, and graceful degradation
                of quarantined (bin, bucket) flushes.  ``None`` keeps
                the legacy contract: failures re-queue unresolved
                requests and re-raise.
      fault_injector: optional seeded
                :class:`~repro_torch.service.faults.FaultInjector` consulted
                at the solve / pricing / cache-load / cache-store sites
                (chaos testing and the faults benchmark).  With
                ``rate=0`` or ``enabled=False`` every broker event is
                bit-identical to a broker without an injector.
      tracer:   optional :class:`~repro_torch.obs.trace.Tracer` — the tick
                emits per-stage spans (materialize, cache probe, per-
                bucket solve flush, pricing, commit, batch groups) and
                tags fault/retry/breaker/degraded/timed-out events onto
                the active span, so a degraded reply in an exported
                trace is attributable to the exact injected fault.
      metrics:  optional :class:`~repro_torch.obs.metrics.MetricsRegistry` —
                telemetry counters mirror into it
                (:meth:`BrokerTelemetry.bind_metrics`), tick latency
                feeds a quantile histogram, tenant caches bind
                hit/miss/eviction counters, solver dispatches record
                per-(backend, bucket) timing, and scheduler queue
                depth / queued bins / per-tenant deficits publish as
                gauges each tick.

    ``tracer``/``metrics`` are pure observers: with both detached
    (default) every instrumented path is bit-identical to the
    pre-observability broker (asserted by
    ``tests/test_observability.py``), and neither ever reads the
    broker's ``clock`` (the tracer keeps its own).
    """

    def __init__(
        self,
        *,
        backend: str = "cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device: str | torch.device = "cuda",
        clock: Callable[[], float] = time.perf_counter,
        max_queued_bins: int | None = None,
        resilience: ResiliencePolicy | None = None,
        fault_injector: FaultInjector | None = None,
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        mesh=None,
    ):
        if backend not in ("reference", "torch", "cuda"):
            raise ValueError(f"unknown MCOP batch backend: {backend!r}")
        self.backend = backend
        self.buckets = tuple(buckets)
        self.device = device
        # one device per broker: mesh=None/False are accepted, anything
        # else names a solver fleet this package does not have
        _single_device(mesh)
        self._devices = 1
        self.clock = clock
        self.resilience = resilience
        self.fault_injector = fault_injector
        self.tracer = tracer
        self.metrics = metrics
        self._obs_gauges = None  # cached gauge instruments (see tick)
        self.telemetry = BrokerTelemetry()
        if metrics is not None:
            self.telemetry.bind_metrics(metrics)
        self._tenants: dict[str, _Tenant] = {}
        self._scheduler = WeightedFairScheduler(max_queued_bins=max_queued_bins)
        self._batch_groups: list = []  # BatchSessionGroup, registration order
        self._rejected_since_tick = 0
        self._deadlines_armed = False
        self._tick = 0

    # -- tenants ---------------------------------------------------------
    def register(
        self,
        name: str,
        profile: AppProfile | None = None,
        cost_model: CostModel | None = None,
        *,
        cache: PlacementCache | None = None,
        quantizer: EnvQuantizer | None = None,
        cache_capacity: int = 4096,
        warm_start=None,
        weight: float = 1.0,
        adaptive_weight: bool = False,
    ) -> _Tenant:
        """Register a served application (or a raw-graph producer).

        With a ``profile`` + ``cost_model`` the tenant accepts
        :meth:`submit`; raw-graph tenants (e.g. the elastic manager,
        whose WCG is built from stage/tier specs) use
        :meth:`submit_graph` and may register with ``profile=None``.
        ``warm_start`` is a snapshot dict or JSON path loaded into the
        tenant cache under the profile's fingerprint guard — a
        mismatched or corrupt snapshot cold-starts silently.
        ``weight`` is the tenant's weighted-fair share of a budgeted
        tick (deficit round robin; see
        :class:`~repro_torch.service.scheduler.WeightedFairScheduler`).
        ``adaptive_weight=True`` additionally opts the tenant into the
        scheduler's load-adaptive weighting: the broker feeds each
        tick's per-tenant service latency into an EWMA, and the
        effective weight scales by inverse recent latency (clamped
        around ``weight``; see
        :meth:`~repro_torch.service.scheduler.WeightedFairScheduler.set_adaptive`).
        """
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if (profile is None) != (cost_model is None):
            raise ValueError("profile and cost_model must be given together")
        # the snapshot guard covers the whole (profile, objective) pair: a
        # cache warmed under one cost model must not serve another
        fingerprint = (
            f"{profile_fingerprint(profile)}:{cost_model.fingerprint}"
            if profile is not None
            else None
        )
        if cache is None:
            cache = PlacementCache(quantizer, capacity=cache_capacity)
        tenant = _Tenant(name, profile, cost_model, cache, fingerprint, weight)
        if warm_start is not None:
            cache.load(warm_start, fingerprint=fingerprint)
        if self.metrics is not None:
            cache.bind_metrics(self.metrics, tenant=name)
        self._tenants[name] = tenant
        self._scheduler.ensure_tenant(name, weight=weight)
        if adaptive_weight:
            self._scheduler.set_adaptive(name)
        return tenant

    def register_batch(
        self,
        name: str,
        capacity: int,
        *,
        threshold: float = 0.10,
        min_interval: int = 1,
        device_telemetry: bool = False,
    ):
        """Attach a :class:`~repro_torch.service.session.BatchSessionGroup`.

        ``capacity`` session slots of tenant ``name`` held as one
        :class:`~repro_torch.core.session_batch.SessionBatch`: the
        group stages a whole tick of observations as arrays and
        :meth:`tick` resolves it with ONE vectorized
        ``tick_sessions`` call against the tenant's shared cache — the
        10⁵–10⁶-user path.  Groups tick after the request queue drains,
        ordered by scheduler weight (descending; registration order
        breaks ties), and each group's service latency feeds the
        scheduler's load-adaptive weighting when the tenant opted in.
        """
        # deferred import: session.py imports the broker module
        from repro_torch.service.session import BatchSessionGroup

        t = self._tenants[name]
        if t.profile is None:
            raise ValueError(
                f"tenant {name!r} has no profile; batch groups need one"
            )
        group = BatchSessionGroup(
            self,
            name,
            capacity=capacity,
            threshold=threshold,
            min_interval=min_interval,
            device_telemetry=device_telemetry,
        )
        self._batch_groups.append(group)
        return group

    def set_weight(self, name: str, weight: float) -> None:
        """Adjust a tenant's weighted-fair share for future ticks."""
        self._tenants[name].weight = float(weight)
        self._scheduler.set_weight(name, weight)

    def tenant(self, name: str) -> _Tenant:
        return self._tenants[name]

    def snapshot(self, name: str) -> dict:
        """Fingerprint-stamped snapshot of one tenant's cache."""
        t = self._tenants[name]
        return t.cache.snapshot(fingerprint=t.fingerprint)

    def save_snapshot(self, name: str, path, *, meta: dict | None = None) -> None:
        t = self._tenants[name]
        t.cache.save(path, fingerprint=t.fingerprint, meta=meta)

    def restore_tick(self, tick: int) -> None:
        """Fast-forward the tick counter to ``tick`` (warm restart).

        Replies stamp the tick they resolved on, so a serving plane
        replaying a journal tail after a crash must first realign the
        counter with the persisted history — otherwise the replayed
        replies would renumber from zero and break bit-identity with
        the uninterrupted run.  Only ever move forward on an idle
        broker: rewinding (or skipping while requests are queued) would
        corrupt armed deadlines and the telemetry timeline.
        """
        tick = int(tick)
        if tick < self._tick:
            raise ValueError(
                f"cannot rewind tick counter {self._tick} -> {tick}"
            )
        if self._scheduler.pending and tick != self._tick:
            raise RuntimeError("restore_tick requires an empty queue")
        self._tick = tick

    # -- submission ------------------------------------------------------
    def _enqueue(self, r: _Request) -> PlacementFuture:
        """Offer a request to the scheduler, resolving rejections inline.

        The backpressure bin is (tenant, graph size, quantized env) —
        exactly the coalescing unit, so joining an already-queued bin is
        always admitted (it costs no extra solver work) and only a
        submission that would open a new bin past the cap is rejected.
        """
        admitted = self._scheduler.submit(
            QueueEntry(r.tenant.name, r, (r.n, r.key), lane=r.lane)
        )
        if not admitted:
            self._rejected_since_tick += 1
            self._event(
                "rejected",
                tenant=r.tenant.name,
                tick=self._tick,
                reason="backpressure",
            )
            r.future.set(
                BrokerReply(
                    None,
                    cache_hit=False,
                    coalesced=False,
                    tick=self._tick,
                    rejected=True,
                )
            )
        return r.future

    def _deadline_tick(self, deadline: int | None) -> int | None:
        """Absolute expiry tick for a submission (arms the deadline sweep)."""
        if deadline is None and self.resilience is not None:
            deadline = self.resilience.deadline_ticks
        if deadline is None:
            return None
        if deadline <= 0:
            raise ValueError("deadline must be positive (ticks)")
        self._deadlines_armed = True
        return self._tick + int(deadline)

    def submit(
        self,
        name: str,
        env: Environment,
        *,
        lane: str = "user",
        deadline: int | None = None,
    ) -> PlacementFuture:
        """Enqueue a solve for ``env`` under the tenant's cost model.

        Args:
          name: registered tenant (must have a profile + cost model).
          env:  the environment to price/partition for; also determines
                the coalescing bin via the tenant cache's quantizer.
          lane: ``"user"`` (weighted-fair) or ``"elastic"`` (strict
                priority, e.g. fleet resizes).
          deadline: optional per-request deadline in ticks — a request
                still queued after that many ticks resolves as
                ``timed_out`` (default: the resilience policy's
                ``deadline_ticks``, or no deadline).
        Returns:
          :class:`PlacementFuture`, resolved by a later :meth:`tick` —
          or immediately with a ``rejected`` reply when the scheduler's
          queued-bin cap is reached.

        Construction is deferred: the WCG is built at the next tick, where
        all of this tenant's pending environments go through ONE vectorized
        ``cost_model.build_batch`` call instead of a Python build per
        request.
        """
        t = self._tenants[name]
        if t.profile is None:
            raise ValueError(
                f"tenant {name!r} has no profile; use submit_graph()"
            )
        return self._enqueue(
            _Request(
                t,
                None,
                t.cache.key(env),
                PlacementFuture(),
                env=env,
                lane=lane,
                expires=self._deadline_tick(deadline),
            )
        )

    def submit_graph(
        self,
        name: str,
        g: WCG,
        env: Environment,
        *,
        lane: str = "user",
        deadline: int | None = None,
    ) -> PlacementFuture:
        """Enqueue a caller-built WCG; ``env`` only determines the bin key.

        Same future/rejection/deadline semantics as :meth:`submit`; used
        by raw-graph tenants (elastic manager, broker sessions carrying
        an already-built controller graph).
        """
        t = self._tenants[name]
        return self._enqueue(
            _Request(
                t,
                g,
                t.cache.key(env),
                PlacementFuture(),
                env=env,
                lane=lane,
                expires=self._deadline_tick(deadline),
            )
        )

    @property
    def pending(self) -> int:
        return self._scheduler.pending

    @property
    def queued_bins(self) -> int:
        """Distinct queued (tenant, bin) pairs — the backpressure gauge."""
        return self._scheduler.queued_bins

    # -- the tick --------------------------------------------------------
    def tick(self, *, budget: int | None = None) -> TickReport:
        """Drain the scheduler: lanes → hits → followers → bucket dispatches.

        Args:
          budget: optional cap on requests drained this tick.  The
            weighted-fair scheduler then splits the budget across
            tenants proportionally to their weights (elastic-lane events
            always drain first); undrained requests stay queued for the
            next tick.  ``None`` (default) drains everything.
        Returns:
          :class:`TickReport` — per-tick telemetry, including the
          per-tenant WFQ ``shares`` and backpressure ``rejected`` count.

        Elastic-lane requests are flushed ahead of user-lane requests;
        within a tenant, FIFO order is preserved, so cache counters and
        placements are bit-identical to N serial controllers sharing one
        cache and observing in submission order (asserted by the
        broker↔serial parity tests).  Deferred (env-only) submissions are
        materialized here, one vectorized cost-model build per tenant,
        and every reply is priced in one vectorized evaluation per graph
        size (see :meth:`_price_replies`).

        Failure containment: if a solve dispatch raises (transient
        device error), every request whose future is still unresolved
        is put back at the front of the queue before the exception
        propagates, so the next :meth:`tick` retries instead of stranding
        waiters forever.
        """
        t0 = self.clock()
        self._tick += 1
        with self._span("broker.tick", tick=self._tick) as root:
            # deadline sweep BEFORE draining: an overdue request must
            # resolve as timed_out, not be served late (the sweep only ever
            # runs once a deadline has actually been armed, so deadline-free
            # brokers pay nothing and stay bit-identical to the historical
            # tick)
            timed_out = 0
            if self._deadlines_armed:
                for e in self._scheduler.expire(
                    lambda e: e.item.expires is not None
                    and e.item.expires < self._tick
                ):
                    if not e.item.future.done:
                        e.item.future.set(
                            BrokerReply(
                                None,
                                cache_hit=False,
                                coalesced=False,
                                tick=self._tick,
                                timed_out=True,
                            )
                        )
                        timed_out += 1
                        self._event(
                            "timed_out",
                            tenant=e.item.tenant.name,
                            tick=self._tick,
                        )
            depth = self._scheduler.pending
            entries = self._scheduler.drain(budget)
            requests = [e.item for e in entries]
            ctx = (
                _TickCtx(
                    self.fault_injector,
                    self.resilience,
                    self._backoff_sleep,
                    entry_of={id(e.item): e for e in entries},
                )
                if self.resilience is not None
                or self.fault_injector is not None
                else None
            )
            try:
                # materialization is inside the containment: a failing
                # deferred build (bad environment) must re-queue innocents,
                # not drop them
                self._materialize(requests, ctx)
                report = self._run_tick(requests, depth, ctx)
            except BaseException as err:
                self._scheduler.requeue(
                    e for e in entries if not e.item.future.done
                )
                if (
                    self.resilience is None
                    or not isinstance(err, Exception)
                    or isinstance(err, KernelError)
                ):
                    raise
                # resilient backstop: an error that escaped the per-bucket
                # quarantine is still contained — unresolved requests are
                # already back at the front of the queue for the next tick
                if ctx is not None:
                    ctx.faults += 1
                self._event(
                    "tick_contained", tick=self._tick, error=type(err).__name__
                )
                report = TickReport(
                    tick=self._tick,
                    queue_depth=depth,
                    requests=len(requests),
                    cache_hits=0,
                    coalesced=0,
                    solved=0,
                    dispatches=0,
                    buckets=(),
                    latency_s=0.0,
                    elastic=sum(r.lane == "elastic" for r in requests),
                    rejected=self._rejected_since_tick,
                    shares=(),
                )
            # batched session groups tick after the request queue: each is
            # one vectorized tick_sessions call, atomic on its own (a
            # failing group keeps its staged observation for retry and does
            # not disturb the already-resolved request futures above)
            report = self._tick_batches(report, ctx)
            if ctx is not None:
                report = dataclasses.replace(
                    report,
                    faults=ctx.faults,
                    retries=ctx.retries,
                    breaker_trips=ctx.breaker_trips,
                    degraded=ctx.degraded,
                )
            if timed_out:
                report = dataclasses.replace(report, timed_out=timed_out)
            report = dataclasses.replace(report, latency_s=self.clock() - t0)
            self._rejected_since_tick = 0
            self.telemetry.record(report)
            root.set(
                queue_depth=report.queue_depth,
                requests=report.requests,
                cache_hits=report.cache_hits,
                coalesced=report.coalesced,
                solved=report.solved,
                dispatches=report.dispatches,
                degraded=report.degraded,
                timed_out=report.timed_out,
                faults=report.faults,
            )
        if self.metrics is not None:
            self._publish_gauges()
        return report

    def _publish_gauges(self) -> None:
        """Post-tick scheduler gauges (cached instruments: no registry
        lookups on the per-tick path)."""
        g = self._obs_gauges
        if g is None:
            g = self._obs_gauges = (
                self.metrics.gauge("broker_queue_depth"),
                self.metrics.gauge("broker_queued_bins"),
                {},  # tenant -> (deficit gauge, weight gauge)
            )
        g[0].set(self._scheduler.pending)
        g[1].set(self._scheduler.queued_bins)
        per_tenant = g[2]
        for name, deficit in self._scheduler.deficits().items():
            pair = per_tenant.get(name)
            if pair is None:
                pair = per_tenant[name] = (
                    self.metrics.gauge("scheduler_deficit", tenant=name),
                    self.metrics.gauge("scheduler_weight", tenant=name),
                )
            pair[0].set(deficit)
            pair[1].set(self._scheduler.weight(name))

    def drain(self) -> int:
        """Resolve every still-queued future as ``rejected`` (shutdown).

        A broker being torn down must not strand waiters: all queued
        requests — whatever their lane or deadline — resolve immediately
        with a ``rejected`` reply, and staged (un-ticked) batch-group
        observations are discarded so the groups can be re-observed
        against another broker.  Returns the number of futures resolved.
        """
        n = 0
        for e in self._scheduler.drain(None):
            if not e.item.future.done:
                e.item.future.set(
                    BrokerReply(
                        None,
                        cache_hit=False,
                        coalesced=False,
                        tick=self._tick,
                        rejected=True,
                    )
                )
                n += 1
        self.telemetry.rejected_requests += n
        for group in self._batch_groups:
            group.discard_staged()
        return n

    def _backoff_sleep(self, seconds: float) -> None:
        """Charge backoff/latency time to the broker clock.

        Injected clocks (anything with ``advance``) are advanced —
        deterministic tests and benchmarks never actually sleep; real
        clocks sleep for real.
        """
        if seconds <= 0:
            return
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(seconds)
        else:
            time.sleep(seconds)

    # -- observability guards (None tracer/registry compile away to no-ops
    # -- without ever touching a clock: the broker's injected clock must be
    # -- read exactly twice per tick with or without instrumentation) --
    def _span(self, name: str, **attrs):
        return (
            self.tracer.span(name, **attrs)
            if self.tracer is not None
            else NULL_SPAN
        )

    def _event(self, name: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.event(name, **attrs)

    def _timer(self, name: str, **labels):
        return (
            self.metrics.timer(name, **labels)
            if self.metrics is not None
            else NULL_SPAN
        )

    def _tick_batches(
        self, report: TickReport, ctx: _TickCtx | None = None
    ) -> TickReport:
        """Run every staged batch group; fold counts into the report.

        Groups run ordered by current scheduler weight (descending,
        registration order breaking ties — the WFQ notion of precedence
        applied at group granularity), and each group's wall time is
        reported to the scheduler as that tenant's service latency,
        which drives the load-adaptive weights of opted-in tenants.
        """
        staged = [g for g in self._batch_groups if g.pending]
        if not staged:
            return report
        staged.sort(key=lambda g: -self._scheduler.weight(g.tenant))
        groups = sessions = hits = solved = 0
        for group in staged:
            g0 = self.clock()
            with self._span("stage.batch_group", tenant=group.tenant):
                try:
                    group_report = group._tick()
                except KernelError:
                    raise
                except Exception as err:
                    # resilient brokers contain a failing group to its own
                    # failure domain: the staged observation is kept (the
                    # group retries next tick) and healthy groups still run
                    if self.resilience is None:
                        raise
                    if ctx is not None:
                        ctx.faults += 1
                    self._event(
                        "group_contained",
                        tenant=group.tenant,
                        tick=self._tick,
                        error=type(err).__name__,
                    )
                    self._scheduler.observe_latency(
                        group.tenant, self.clock() - g0
                    )
                    continue
            self._scheduler.observe_latency(group.tenant, self.clock() - g0)
            if group_report is None:
                continue
            groups += 1
            sessions += int(np.count_nonzero(group_report.active))
            hits += group_report.hits + group_report.coalesced
            solved += group_report.solved
            if ctx is not None:
                ctx.faults += group_report.faults
                ctx.retries += group_report.retries
                ctx.breaker_trips += group_report.breaker_trips
                if group_report.degraded is not None:
                    ctx.degraded += int(
                        np.count_nonzero(group_report.degraded)
                    )
        return dataclasses.replace(
            report,
            batch_groups=groups,
            batch_sessions=sessions,
            batch_hits=hits,
            batch_solved=solved,
        )

    def _materialize(
        self, requests: list[_Request], ctx: _TickCtx | None = None
    ) -> None:
        """Build deferred WCGs: one ``build_batch`` per tenant per tick.

        Rows of the vectorized build are bit-identical to the scalar
        ``cost_model.build`` (same code path, batch of K), so deferral
        never changes a placement or a reported cost.

        Resilient brokers additionally quarantine requests whose
        *environment* carries a non-finite scalar before the vectorized
        build: one poisoned observation must not abort the whole
        tenant's build (the legacy path lets ``build_batch`` raise —
        ``NonFiniteWeightError`` — and the tick containment re-queue).
        A quarantined request resolves immediately as ``rejected``: its
        input is invalid, so no placement — stale or fallback — can
        honestly answer it.
        """
        deferred: dict[str, list[_Request]] = {}
        for r in requests:
            if r.g is None:
                deferred.setdefault(r.tenant.name, []).append(r)
        if not deferred:
            return
        with self._span(
            "stage.materialize",
            tenants=len(deferred),
            requests=sum(len(rs) for rs in deferred.values()),
        ):
            self._materialize_deferred(deferred, ctx)

    def _materialize_deferred(
        self, deferred: dict[str, list[_Request]], ctx: _TickCtx | None
    ) -> None:
        for name, rs in deferred.items():
            if ctx is not None and ctx.policy is not None:
                kept = []
                for r in rs:
                    if all(
                        math.isfinite(float(v))
                        for v in dataclasses.astuple(r.env)
                    ):
                        kept.append(r)
                        continue
                    self._rejected_since_tick += 1
                    self._event(
                        "rejected",
                        tenant=name,
                        tick=self._tick,
                        reason="non_finite_env",
                    )
                    r.future.set(
                        BrokerReply(
                            None,
                            cache_hit=False,
                            coalesced=False,
                            tick=self._tick,
                            rejected=True,
                        )
                    )
                rs = kept
                if not rs:
                    continue
            t = self._tenants[name]
            batch = t.cost_model.build_batch(t.profile, [r.env for r in rs])
            for i, r in enumerate(rs):
                r.g = batch.wcg(i)

    @staticmethod
    def _price_rows(
        graphs: list[WCG], masks: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized Eq.-2 + all-local pricing of (graph, mask) rows.

        One :meth:`~repro_torch.core.graph.WCGBatch.total_cost` evaluation per
        distinct graph size (unpadded, so every number is bit-identical
        to the scalar per-row path — see ``repro_torch.core.pricing``).
        Returns ``(partial, no_offload)`` float arrays aligned with the
        rows.
        """
        partial = np.zeros(len(graphs))
        no_off = np.zeros(len(graphs))
        by_n: dict[int, list[int]] = {}
        for i, g in enumerate(graphs):
            by_n.setdefault(g.n, []).append(i)
        for n, idxs in by_n.items():
            batch = WCGBatch.from_wcgs([graphs[i] for i in idxs], m=n)
            stacked = np.stack([masks[i] for i in idxs])
            partial[idxs] = batch.total_cost(stacked)
            no_off[idxs] = np.asarray(batch.w_local).sum(axis=-1)
        return partial, no_off

    def _reply(self, result: MCOPResult, *, cache_hit: bool, coalesced: bool):
        return BrokerReply(
            result, cache_hit=cache_hit, coalesced=coalesced, tick=self._tick
        )

    # -- fault-site wrappers (ctx=None compiles away to the legacy path) --
    def _cache_lookup(
        self, r: _Request, index: int, ctx: _TickCtx | None
    ) -> np.ndarray | None:
        """Cache probe under the ``cache_load`` fault site.

        A firing error/corrupt decision discards the loaded value — the
        request is treated as a miss and re-solved (the cache is an
        optimization, never ground truth, so a lost load is always safe).
        Latency faults charge the clock and return the real value.
        """
        if ctx is not None and ctx.injector is not None:
            d = ctx.injector.decide("cache_load", self._tick, index)
            if d.fires:
                ctx.faults += 1
                self._event(
                    "fault",
                    site="cache_load",
                    kind=d.kind,
                    tick=self._tick,
                    index=index,
                )
                if d.kind == "latency":
                    ctx.sleep(d.delay_s)
                else:
                    return None
        return r.tenant.cache.lookup(r.key, expected_n=r.g.n)

    def _cache_store(
        self, r: _Request, slot: int, mask: np.ndarray, ctx: _TickCtx | None
    ) -> None:
        """Representative store under the ``cache_store`` fault site.

        A dropped store is silently absorbed: the bin simply misses again
        on a later tick and re-solves — no stale or partial entry is ever
        written.
        """
        if ctx is not None and ctx.injector is not None:
            d = ctx.injector.decide("cache_store", self._tick, slot)
            if d.fires:
                ctx.faults += 1
                self._event(
                    "fault",
                    site="cache_store",
                    kind=d.kind,
                    tick=self._tick,
                    index=slot,
                )
                if d.kind == "latency":
                    ctx.sleep(d.delay_s)
                else:
                    return
        r.tenant.cache.store(r.key, mask)

    def _priced_rows(
        self,
        graphs: list[WCG],
        masks: list[np.ndarray],
        ctx: _TickCtx | None,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """:meth:`_price_rows` under the ``pricing`` fault site, retried.

        Returns ``None`` when every attempt failed (resilient brokers
        only) — the caller degrades those rows to fallback replies.
        """
        if ctx is None:
            with self._timer("broker_price_duration_s"):
                return self._price_rows(graphs, masks)
        base = ctx.price_seq
        ctx.price_seq += ctx.attempts
        for attempt in range(ctx.attempts):
            if attempt:
                ctx.retries += 1
                self._event(
                    "retry", site="pricing", attempt=attempt, tick=self._tick
                )
                if ctx.policy is not None:
                    ctx.sleep(ctx.policy.retry.backoff(attempt - 1))
            try:
                if ctx.injector is not None:
                    d = ctx.injector.decide(
                        "pricing", self._tick, base + attempt
                    )
                    if d.fires:
                        ctx.faults += 1
                        self._event(
                            "fault",
                            site="pricing",
                            kind=d.kind,
                            tick=self._tick,
                            index=base + attempt,
                        )
                        if d.kind == "latency":
                            ctx.sleep(d.delay_s)
                        else:
                            raise InjectedFault(
                                "pricing", self._tick, base + attempt, d.kind
                            )
                with self._timer("broker_price_duration_s"):
                    return self._price_rows(graphs, masks)
            except Exception:
                if ctx.policy is None:
                    raise
        return None

    def _dispatch(
        self, wb: WCGBatch, m: int, ctx: _TickCtx | None
    ) -> list[MCOPResult] | None:
        """One bucket's ``mcop_batch`` under retry/breaker/fault policy.

        Resilient path, per attempt: pick the effective backend (for a
        solve on the CPU the circuit breaker walks cuda → torch →
        reference past open circuits; on a GPU the backend never
        changes), consult the injector (corruption poisons a COPY of
        the batch — caught by ``validate_finite`` before it can be
        silently solved), dispatch, and reject non-finite cut values.
        Returns ``None`` when all attempts failed — the caller
        quarantines exactly this bucket's requests, nothing else.
        A ``KernelError`` (no device, failed build, refused launch) is
        never retried, counted or degraded: it propagates.
        """
        if ctx is None:
            with self._timer(
                "mcop_dispatch_duration_s",
                backend=self.backend, bucket=m, devices=self._devices,
            ):
                return mcop_batch(
                    wb, backend=self.backend, buckets=(m,),
                    device=self.device,
                )
        policy = ctx.policy
        breaker = policy.breaker if policy is not None else None
        on_cpu = torch.device(self.device).type == "cpu"
        for attempt in range(ctx.attempts):
            if attempt:
                ctx.retries += 1
                self._event(
                    "retry",
                    site="solve",
                    attempt=attempt,
                    bucket=m,
                    tick=self._tick,
                )
                if policy is not None:
                    ctx.sleep(policy.retry.backoff(attempt - 1))
            backend = (
                breaker.backend(self.backend, self._tick, escalate=on_cpu)
                if breaker is not None
                else self.backend
            )
            index = ctx.solve_seq
            ctx.solve_seq += 1
            use = wb
            try:
                if ctx.injector is not None:
                    d = ctx.injector.decide("solve", self._tick, index)
                    if d.fires:
                        ctx.faults += 1
                        self._event(
                            "fault",
                            site="solve",
                            kind=d.kind,
                            tick=self._tick,
                            index=index,
                            bucket=m,
                        )
                        if d.kind == "latency":
                            ctx.sleep(d.delay_s)
                        elif d.kind == "error":
                            raise InjectedFault("solve", self._tick, index)
                        else:
                            use = poison_batch(wb)
                use.validate_finite()
                with self._timer(
                    "mcop_dispatch_duration_s",
                    backend=backend, bucket=m, devices=self._devices,
                ):
                    out = mcop_batch(
                        use, backend=backend, buckets=(m,),
                        device=self.device,
                    )
                if not all(math.isfinite(res.min_cut) for res in out):
                    raise RuntimeError(
                        "non-finite min_cut from solver dispatch"
                    )
                if breaker is not None:
                    breaker.record_success(backend)
                return out
            except KernelError:
                raise
            except Exception:
                if breaker is not None and breaker.record_failure(
                    backend, self._tick
                ):
                    ctx.breaker_trips += 1
                    self._event(
                        "breaker_trip",
                        backend=backend,
                        bucket=m,
                        tick=self._tick,
                    )
                if policy is None:
                    raise
        return None

    def _fallback_reply(
        self,
        r: _Request,
        ctx: _TickCtx,
        *,
        count: bool = True,
        cache_hit: bool = False,
        coalesced: bool = False,
    ) -> None:
        """Serve the safe placement: stale cached bin, else §4.3 no-offload.

        The stale probe is uncounted — the request's single cache-stat
        event is the miss recorded here when ``count`` (hits that
        degraded at pricing were already counted at classification).
        Fallbacks never store: the bin stays cold and re-solves once the
        fault clears.
        """
        mask = r.tenant.cache.lookup(r.key, expected_n=r.g.n)
        no_off = float(np.asarray(r.g.w_local).sum())
        if mask is None:
            res = MCOPResult(
                min_cut=no_off,
                local_mask=np.ones(r.g.n, dtype=bool),
                phases=[],
            )
        else:
            res = baselines.reprice_clamped_priced(
                float(r.g.total_cost(mask)), no_off, mask
            )
        if count:
            r.tenant.cache.record(False)
        ctx.degraded += 1
        self._event(
            "degraded",
            tenant=r.tenant.name,
            tick=self._tick,
            stale=mask is not None,
        )
        r.future.set(
            BrokerReply(
                res,
                cache_hit=cache_hit,
                coalesced=coalesced,
                tick=self._tick,
                degraded=True,
            )
        )

    def _quarantine(
        self, rep: _Request, fols: list[_Request], ctx: _TickCtx
    ) -> None:
        """Contain one (bin, bucket) flush failure to its own requests."""
        if ctx.policy is not None and ctx.policy.degrade == "requeue":
            self._scheduler.requeue(
                ctx.entry_of[id(r)]
                for r in (rep, *fols)
                if id(r) in ctx.entry_of
            )
            return
        self._fallback_reply(rep, ctx)
        for f in fols:
            self._fallback_reply(f, ctx, coalesced=True)

    def _run_tick(
        self,
        requests: list[_Request],
        depth: int,
        ctx: _TickCtx | None = None,
    ) -> TickReport:
        # requests quarantined at materialization (invalid environment)
        # are already resolved and never got a graph
        requests = [r for r in requests if r.g is not None]
        hits = coalesced = 0
        solves: list[_Request] = []
        hit_rows: list[tuple[_Request, np.ndarray]] = []
        # coalescing key includes the vertex count: a raw-graph tenant may
        # legally mix graph sizes in one env bin, and a follower must never
        # be handed a wrong-length mask (mirrors the cache's expected_n)
        rep_slot: dict[tuple[str, int, tuple[int, ...]], int] = {}
        followers: dict[int, list[_Request]] = {}
        with self._span("stage.cache_probe", requests=len(requests)) as probe:
            for i, r in enumerate(requests):
                mask = self._cache_lookup(r, i, ctx)
                if mask is not None:
                    r.tenant.cache.record(True)
                    hits += 1
                    hit_rows.append((r, mask))
                    continue
                slot_key = (r.tenant.name, r.g.n, r.key)
                if slot_key in rep_slot:
                    coalesced += 1
                    followers.setdefault(rep_slot[slot_key], []).append(r)
                    continue
                rep_slot[slot_key] = len(solves)
                solves.append(r)
            probe.set(hits=hits, coalesced=coalesced, misses=len(solves))

        # cache hits are priced in ONE vectorized evaluation per graph
        # size and resolved BEFORE any solver dispatch — a failing
        # dispatch must not strand futures the cache already answered
        if hit_rows:
            with self._span(
                "stage.pricing", phase="hits", rows=len(hit_rows)
            ):
                priced = self._priced_rows(
                    [r.g for r, _ in hit_rows], [m for _, m in hit_rows], ctx
                )
            if priced is None:
                # pricing exhausted its retries: the hits were already
                # counted at classification, serve each the fallback
                for r, _ in hit_rows:
                    self._fallback_reply(r, ctx, count=False, cache_hit=True)
            else:
                h_partial, h_no_off = priced
                for i, (r, mask) in enumerate(hit_rows):
                    r.future.set(
                        self._reply(
                            baselines.reprice_clamped_priced(
                                float(h_partial[i]), float(h_no_off[i]), mask
                            ),
                            cache_hit=True,
                            coalesced=False,
                        )
                    )

        # one mcop_batch call per static shape bucket, shared across
        # tenants; each bucket is packed into a WCGBatch once, so the
        # dispatch skips the per-graph packing pass.  A bucket whose
        # dispatch exhausts its retries is quarantined — its slots stay
        # None and are degraded/re-queued after the healthy buckets
        # commit below.
        by_bucket: dict[int, list[int]] = {}
        for i, r in enumerate(solves):
            by_bucket.setdefault(_bucket_size(r.g.n, self.buckets), []).append(i)
        solved: list[MCOPResult | None] = [None] * len(solves)
        dispatches = 0
        dispatched_buckets: list[int] = []
        quarantined: list[int] = []
        for m, idxs in sorted(by_bucket.items()):
            with self._span(
                "stage.solve_flush",
                bucket=m,
                batch=len(idxs),
                backend=self.backend,
                devices=self._devices,
            ):
                batch = self._dispatch(
                    WCGBatch.from_wcgs([solves[i].g for i in idxs], m=m),
                    m,
                    ctx,
                )
            if batch is None:
                self._event(
                    "quarantine", bucket=m, requests=len(idxs), tick=self._tick
                )
                quarantined.extend(idxs)
                continue
            dispatches += 1
            dispatched_buckets.append(m)
            for i, res in zip(idxs, batch):
                solved[i] = res

        # followers are priced in one more vectorized evaluation per graph
        # size: a follower's row carries its representative's RAW solved
        # mask, and the reply select below resolves it exactly like
        # reprice_clamped would.  Representatives only need the all-local
        # baseline for the §4.3 clamp — a single w_local sum each
        # (bit-identical to no_offloading(g).cost).
        row_graphs: list[WCG] = []
        row_masks: list[np.ndarray] = []

        def add_row(g: WCG, mask) -> int:
            row_graphs.append(g)
            row_masks.append(np.asarray(mask, dtype=bool))
            return len(row_graphs) - 1

        rep_no_off = [float(r.g.w_local.sum()) for r in solves]
        fol_rows = {
            s: [add_row(f.g, solved[s].local_mask) for f in fs]
            for s, fs in followers.items()
            if solved[s] is not None
        }
        if row_graphs:
            with self._span(
                "stage.pricing", phase="followers", rows=len(row_graphs)
            ):
                priced = self._priced_rows(row_graphs, row_masks, ctx)
        else:
            priced = (np.zeros(0), np.zeros(0))
        # follower repricing degraded: reps still commit below, and each
        # follower falls back (its stale probe then finds the mask its
        # representative just stored — still the freshest safe answer)
        partial, no_off = priced if priced is not None else (None, None)

        # counter recording for misses/followers happens here, after the
        # dispatches succeeded: a failed tick re-queues these requests, and
        # the retry must not double-count them (a serial shared-cache loop
        # would count each request exactly once).  Followers count as hits:
        # serially they would have hit the representative's put().
        with self._span("stage.commit", representatives=len(solves)):
            for slot, r in enumerate(solves):
                if solved[slot] is None:
                    continue  # quarantined bucket, handled below
                # §4.3 clamp against the baseline; the reply keeps the
                # solver's own cut value (shared helper with the serial path)
                rep_clamped = rep_no_off[slot] < solved[slot].min_cut
                candidate = baselines.clamp_no_offloading_priced(
                    solved[slot], rep_no_off[slot]
                )
                r.tenant.cache.record(False)
                self._cache_store(r, slot, candidate.local_mask, ctx)
                r.future.set(
                    self._reply(candidate, cache_hit=False, coalesced=False)
                )
                for f, fi in zip(
                    followers.get(slot, ()), fol_rows.get(slot, ())
                ):
                    if partial is None:
                        self._fallback_reply(f, ctx, coalesced=True)
                        continue
                    # a clamped representative hands followers the all-local
                    # mask, whose price is exactly the no-offload baseline
                    if rep_clamped:
                        res = MCOPResult(
                            min_cut=float(no_off[fi]),
                            local_mask=np.ones(f.g.n, dtype=bool),
                            phases=[],
                        )
                    else:
                        res = baselines.reprice_clamped_priced(
                            float(partial[fi]),
                            float(no_off[fi]),
                            row_masks[fi],
                        )
                    f.tenant.cache.record(True)
                    f.future.set(
                        self._reply(res, cache_hit=True, coalesced=True)
                    )

        for slot in quarantined:
            self._quarantine(
                solves[slot], list(followers.get(slot, ())), ctx
            )

        shares: dict[str, int] = {}
        for r in requests:
            shares[r.tenant.name] = shares.get(r.tenant.name, 0) + 1
        report = TickReport(
            tick=self._tick,
            queue_depth=depth,
            requests=len(requests),
            cache_hits=hits,
            coalesced=coalesced,
            solved=sum(res is not None for res in solved),
            dispatches=dispatches,
            buckets=tuple(dispatched_buckets),
            # latency is stamped by tick() once batch groups have run, so
            # the injected clock is read exactly twice per tick
            latency_s=0.0,
            elastic=sum(r.lane == "elastic" for r in requests),
            rejected=self._rejected_since_tick,
            shares=tuple(sorted(shares.items())),
        )
        return report
