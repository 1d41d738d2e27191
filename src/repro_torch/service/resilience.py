"""Retry, deadline and circuit-breaker policies for the offload broker.

Before this layer a single failing solve aborted the *entire* broker
tick and re-raised to the caller — acceptable for a library, not for a
serving tier.  The paper gives us the safety net that makes graceful
degradation sound: the §4.3 no-offload clamp means the all-local plan
is *always* a valid placement, so on persistent failure a request can
be served a fallback (a stale cached bin if one exists, else the
no-offload plan) marked ``degraded=True`` instead of an exception.

The policy objects here are plain deterministic state machines — no
wall-clock reads, no randomness — so chaos tests replay bit-identically
under injected clocks:

* :class:`RetryPolicy` — bounded retries with exponential backoff;
  backoff time is charged to the broker's (possibly injected) clock.
* :class:`CircuitBreaker` — per-backend consecutive-failure counter
  that opens a backend for ``cooldown_ticks``.  For solves that run on
  the CPU it escalates dispatches down the chain **cuda → torch →
  reference** (the reference solver is pure numpy).  For solves on a GPU
  it never changes the backend: a kernel is not answered for by its plain
  version nor by the CPU, so the dispatch retries as asked and then
  degrades to the §4.3 fallback reply.
* :class:`ResiliencePolicy` — the bundle the broker accepts
  (``OffloadBroker(resilience=...)``): retry policy, an optional
  per-request deadline (in ticks; overdue queued requests resolve as
  :attr:`~repro_torch.service.broker.BrokerReply.timed_out`), the degradation
  mode for quarantined work (``"fallback"`` serves safe placements,
  ``"requeue"`` retries next tick), and the optional breaker.

``resilience=None`` (the default) preserves the legacy contract
exactly: failures re-queue unresolved requests and re-raise, batched
session ticks stay atomic.  Everything in this module is opt-in.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "InjectedClock",
    "RetryPolicy",
    "CircuitBreaker",
    "ResiliencePolicy",
    "BACKEND_ESCALATION",
]

# Escalation chain, fastest/most-fragile first.  The numpy reference
# solver is the terminal fallback: numpy only.  Walked only for solves on
# the CPU (see CircuitBreaker.backend).
BACKEND_ESCALATION = ("cuda", "torch", "reference")


class InjectedClock:
    """Deterministic monotonic clock for tests and replayable benchmarks.

    Reads return the current value; retry backoff and latency faults
    ``advance`` it instead of sleeping, so a chaos run's latency
    telemetry is an exact function of the fault schedule.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("cannot advance a clock backwards")
        self._now += float(seconds)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff.

    ``max_retries`` is the number of RE-tries: a dispatch gets
    ``max_retries + 1`` attempts total.  Backoff for attempt ``a``
    (0-based, charged between attempt ``a`` and ``a+1``) is
    ``min(base_backoff_s × multiplier^a, max_backoff_s)``.
    """

    max_retries: int = 2
    base_backoff_s: float = 0.001
    multiplier: float = 2.0
    max_backoff_s: float = 0.050

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    @property
    def attempts(self) -> int:
        return self.max_retries + 1

    def backoff(self, attempt: int) -> float:
        return min(
            self.base_backoff_s * self.multiplier ** max(attempt, 0),
            self.max_backoff_s,
        )


class CircuitBreaker:
    """Per-backend breaker escalating cuda → torch → reference on the CPU.

    ``threshold`` consecutive failures open a backend for
    ``cooldown_ticks`` broker ticks; while open, :meth:`backend` walks
    the escalation chain from the preferred backend to the first closed
    one (the terminal ``"reference"`` is returned even when open — there
    is nothing further to escalate to).  A success closes the counter;
    cooldown expiry re-admits the backend (half-open: the next failure
    streak re-opens it).  With ``escalate=False`` — what the callers pass
    for a solve on a GPU — trips are still counted but the backend stays
    the preferred one.
    """

    def __init__(self, *, threshold: int = 3, cooldown_ticks: int = 8):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        if cooldown_ticks <= 0:
            raise ValueError("cooldown_ticks must be positive")
        self.threshold = int(threshold)
        self.cooldown_ticks = int(cooldown_ticks)
        self.trips = 0  # lifetime count of open transitions
        self._consecutive: dict[str, int] = {}
        self._open_until: dict[str, int] = {}

    def is_open(self, backend: str, tick: int) -> bool:
        return tick < self._open_until.get(backend, 0)

    def backend(self, preferred: str, tick: int, *, escalate: bool = True) -> str:
        """Effective backend for this dispatch, given open circuits."""
        if not escalate:
            return preferred
        try:
            start = BACKEND_ESCALATION.index(preferred)
        except ValueError:
            return preferred  # unknown backend: breaker does not apply
        for candidate in BACKEND_ESCALATION[start:]:
            if not self.is_open(candidate, tick):
                return candidate
        return BACKEND_ESCALATION[-1]

    def record_failure(self, backend: str, tick: int) -> bool:
        """Count one failure; returns True when this trip OPENED the circuit."""
        count = self._consecutive.get(backend, 0) + 1
        if count >= self.threshold:
            self._consecutive[backend] = 0
            self._open_until[backend] = tick + self.cooldown_ticks
            self.trips += 1
            return True
        self._consecutive[backend] = count
        return False

    def record_success(self, backend: str) -> None:
        self._consecutive[backend] = 0

    def state(self) -> dict:
        """Telemetry snapshot (copies; safe to mutate)."""
        return {
            "trips": self.trips,
            "consecutive": dict(self._consecutive),
            "open_until": dict(self._open_until),
        }


@dataclasses.dataclass
class ResiliencePolicy:
    """What :class:`~repro_torch.service.broker.OffloadBroker` does on failure.

    Attributes:
      retry:          per-dispatch retry/backoff schedule.
      deadline_ticks: default per-request deadline — a request still
                      queued ``deadline_ticks`` ticks after submission
                      resolves as ``timed_out`` (``None`` = no default;
                      ``submit(..., deadline=)`` can still set one per
                      request).
      degrade:        what happens to a (bin, bucket)'s requests when
                      its flush exhausts retries — ``"fallback"`` serves
                      each a safe placement (stale cached bin if
                      available, else the §4.3 no-offload plan) marked
                      ``degraded=True``; ``"requeue"`` pushes them back
                      for the next tick (deadlines bound the wait).
      breaker:        optional shared :class:`CircuitBreaker`.
    """

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    deadline_ticks: int | None = None
    degrade: str = "fallback"
    breaker: CircuitBreaker | None = None

    def __post_init__(self) -> None:
        if self.degrade not in ("fallback", "requeue"):
            raise ValueError("degrade must be 'fallback' or 'requeue'")
        if self.deadline_ticks is not None and self.deadline_ticks <= 0:
            raise ValueError("deadline_ticks must be positive (or None)")
