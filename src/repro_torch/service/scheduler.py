"""Weighted-fair queueing for the offload broker's flush order.

Two-level lanes (elastic ahead of user) are enough for one
dominant tenant, but under mixed multi-tenant load a chatty tenant can
monopolize every tick while a light one starves.  This module replaces
the lane *sort* with a real scheduler:

* **Strict priority lane** (``lane="elastic"``) — fleet resize events
  drain first, FIFO, and are exempt from backpressure: a shrinking
  fleet must re-place before any user refresh is served a placement
  solved for capacity that no longer exists.
* **Deficit round robin** over per-tenant FIFO queues for the user
  lane.  Every rotation round credits each backlogged tenant
  ``quantum × weight``; a tenant then serves one request per unit of
  accumulated deficit.  Rotation order is tenant-registration order and
  everything is integer/FIFO-deterministic — the same submissions always
  drain in the same order (asserted by the fairness tests).  Over any
  backlogged window tenants share tick capacity proportionally to their
  weights; fractional weights work because deficit accumulates across
  rounds.
* **Backpressure on queued bins** — the broker's unit of solver work is
  the *distinct* (tenant, environment-bin) pair, not the request (all
  same-bin requests coalesce into one solve).  The cap therefore counts
  distinct queued bins: a submission that would open a new bin past
  ``max_queued_bins`` is rejected (the broker resolves its future with a
  rejection reply), while a request joining an already-queued bin is
  always admitted — it costs no additional solver work.

* **Load-adaptive weights** (optional, per tenant) — a tenant may opt
  into inverse recent-latency weighting (:meth:`set_adaptive`): the
  broker reports each tick's per-tenant service latency, an EWMA tracks
  it, and the tenant's effective weight scales by mean-latency/own-EWMA
  (clamped), so a tenant whose ticks keep consuming the solver is
  automatically damped and light tenants are boosted.  Weights only
  move between drains, so a drain is still fully deterministic.

The scheduler is transport-agnostic and holds opaque items; the broker
wraps its requests in :class:`QueueEntry`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Hashable, Iterable

__all__ = ["QueueEntry", "WeightedFairScheduler"]

PRIORITY_LANE = "elastic"


@dataclasses.dataclass
class QueueEntry:
    """One queued unit of work.

    Attributes:
      tenant:  scheduling principal (per-tenant weight/queue).
      item:    opaque payload (the broker's request object).
      bin_key: hashable coalescing bin; backpressure counts distinct
               queued (tenant, bin_key) pairs in the user lane.
      lane:    ``"user"`` (weighted-fair) or ``"elastic"`` (strict
               priority, exempt from backpressure).
    """

    tenant: str
    item: Any
    bin_key: Hashable
    lane: str = "user"


class WeightedFairScheduler:
    """Deficit-round-robin queue with a strict priority lane.

    Parameters:
      quantum:         deficit credited per (weight-1.0) tenant per
                       rotation round.  1.0 means "one request per round
                       per unit weight" — the natural unit here, since
                       every request costs one coalescing slot.
      max_queued_bins: backpressure cap on distinct queued user-lane
                       (tenant, bin) pairs; ``None`` disables rejection.
    """

    def __init__(
        self,
        *,
        quantum: float = 1.0,
        max_queued_bins: int | None = None,
    ):
        if quantum <= 0:
            raise ValueError("quantum must be positive")
        if max_queued_bins is not None and max_queued_bins <= 0:
            raise ValueError("max_queued_bins must be positive (or None)")
        self.quantum = float(quantum)
        self.max_queued_bins = max_queued_bins
        self._tenants: list[str] = []            # rotation order
        self._weights: dict[str, float] = {}
        self._queues: dict[str, deque[QueueEntry]] = {}
        self._deficit: dict[str, float] = {}
        self._priority: deque[QueueEntry] = deque()
        self._bin_counts: dict[tuple[str, Hashable], int] = {}
        self._adaptive: dict[str, dict] = {}  # load-adaptive weight state
        self._cursor = 0  # rotation position, persisted ACROSS drains

    # -- tenants ---------------------------------------------------------
    def ensure_tenant(self, name: str, *, weight: float = 1.0) -> None:
        """Register ``name`` in the rotation (idempotent; keeps order)."""
        if name not in self._weights:
            self._tenants.append(name)
            self._queues[name] = deque()
            self._deficit[name] = 0.0
        self.set_weight(name, weight)

    def set_weight(self, name: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        if name not in self._weights and name not in self._queues:
            raise KeyError(f"unknown tenant {name!r}; call ensure_tenant first")
        self._weights[name] = float(weight)
        adaptive = self._adaptive.get(name)
        if adaptive is not None:
            adaptive["base"] = float(weight)

    def weight(self, name: str) -> float:
        return self._weights[name]

    # -- load-adaptive weights -------------------------------------------
    def set_adaptive(
        self,
        name: str,
        *,
        alpha: float = 0.25,
        floor: float = 0.25,
        ceiling: float = 4.0,
    ) -> None:
        """Opt ``name`` into load-adaptive weighting.

        The broker (or any caller) reports per-tenant service latency via
        :meth:`observe_latency`; each report updates an EWMA and
        recomputes every adaptive tenant's effective weight as::

            base × (mean latency across adaptive tenants) / (own EWMA)

        clamped to ``[base × floor, base × ceiling]`` — inverse
        recent-latency fairness: a tenant whose work keeps consuming the
        solver (high service latency) is damped, a light one boosted, so
        expensive ticks cost share.  Static-weight tenants are
        untouched, and DRR determinism is preserved (weights only change
        inside ``observe_latency``, never mid-drain).
        """
        if name not in self._weights:
            raise KeyError(f"unknown tenant {name!r}; call ensure_tenant first")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if floor <= 0 or ceiling < floor:
            raise ValueError("need 0 < floor <= ceiling")
        self._adaptive[name] = {
            "alpha": float(alpha),
            "floor": float(floor),
            "ceiling": float(ceiling),
            "base": self._weights[name],
            "ewma": None,
        }

    def observe_latency(self, name: str, seconds: float) -> None:
        """Feed one service-latency sample for ``name`` (no-op for
        tenants without :meth:`set_adaptive`); rebalances all adaptive
        tenants' weights against each other."""
        state = self._adaptive.get(name)
        if state is None:
            return
        seconds = max(float(seconds), 0.0)
        state["ewma"] = (
            seconds
            if state["ewma"] is None
            else state["alpha"] * seconds + (1.0 - state["alpha"]) * state["ewma"]
        )
        observed = {
            n: s for n, s in self._adaptive.items() if s["ewma"] is not None
        }
        mean = sum(s["ewma"] for s in observed.values()) / len(observed)
        for n, s in observed.items():
            if s["ewma"] <= 0.0 or mean <= 0.0:
                self._weights[n] = s["base"]
                continue
            raw = s["base"] * mean / s["ewma"]
            self._weights[n] = min(
                max(raw, s["base"] * s["floor"]), s["base"] * s["ceiling"]
            )

    def adaptive_state(self, name: str) -> dict | None:
        """Copy of a tenant's adaptive-weight state (telemetry/tests)."""
        state = self._adaptive.get(name)
        return dict(state) if state is not None else None

    # -- submission ------------------------------------------------------
    def submit(self, entry: QueueEntry) -> bool:
        """Enqueue; returns False when backpressure rejects the entry.

        Priority-lane entries always enter.  A user-lane entry is
        rejected only when it would open a NEW (tenant, bin) pair past
        ``max_queued_bins`` — joining an already-queued bin is free
        (it coalesces into that bin's solve).
        """
        if entry.lane == PRIORITY_LANE:
            self._priority.append(entry)
            return True
        self.ensure_tenant(entry.tenant, weight=self._weights.get(entry.tenant, 1.0))
        bin_id = (entry.tenant, entry.bin_key)
        if bin_id not in self._bin_counts:
            if (
                self.max_queued_bins is not None
                and len(self._bin_counts) >= self.max_queued_bins
            ):
                return False
            self._bin_counts[bin_id] = 0
        self._bin_counts[bin_id] += 1
        self._queues[entry.tenant].append(entry)
        return True

    def requeue(self, entries: Iterable[QueueEntry]) -> None:
        """Push entries back at the FRONT, preserving their order.

        The broker's failure containment: a failed tick returns its
        unresolved requests so the next tick retries them before any
        newer work.  Bypasses backpressure — these entries were already
        admitted once.
        """
        entries = list(entries)
        for entry in reversed(entries):
            if entry.lane == PRIORITY_LANE:
                self._priority.appendleft(entry)
            else:
                self.ensure_tenant(
                    entry.tenant, weight=self._weights.get(entry.tenant, 1.0)
                )
                bin_id = (entry.tenant, entry.bin_key)
                self._bin_counts[bin_id] = self._bin_counts.get(bin_id, 0) + 1
                self._queues[entry.tenant].appendleft(entry)

    def expire(self, predicate) -> list[QueueEntry]:
        """Remove and return every queued entry matching ``predicate``.

        The broker's deadline sweep: entries whose request outlived its
        deadline are pulled out of the queues (priority lane first, then
        per-tenant FIFO in rotation order) so their futures can resolve
        as timed-out instead of waiting for a drain that may never reach
        them.  User-lane bin counts are released like :meth:`_pop`, so
        backpressure sees the freed bins immediately.
        """
        removed: list[QueueEntry] = []

        def split(q: deque[QueueEntry]) -> deque[QueueEntry]:
            kept: deque[QueueEntry] = deque()
            for entry in q:
                (removed if predicate(entry) else kept).append(entry)
            return kept

        self._priority = split(self._priority)
        for tenant in self._tenants:
            self._queues[tenant] = split(self._queues[tenant])
        for entry in removed:
            if entry.lane == PRIORITY_LANE:
                continue
            bin_id = (entry.tenant, entry.bin_key)
            left = self._bin_counts.get(bin_id, 1) - 1
            if left <= 0:
                self._bin_counts.pop(bin_id, None)
            else:
                self._bin_counts[bin_id] = left
        return removed

    # -- draining --------------------------------------------------------
    def _pop(self, tenant: str) -> QueueEntry:
        entry = self._queues[tenant].popleft()
        bin_id = (entry.tenant, entry.bin_key)
        left = self._bin_counts.get(bin_id, 1) - 1
        if left <= 0:
            self._bin_counts.pop(bin_id, None)
        else:
            self._bin_counts[bin_id] = left
        return entry

    def drain(self, budget: int | None = None) -> list[QueueEntry]:
        """Dequeue up to ``budget`` entries (all, when ``None``).

        Priority lane first (FIFO), then DRR rotation over tenant
        queues: each visit credits the tenant ``quantum × weight`` and
        serves one entry per whole unit of deficit, FIFO within a
        tenant.  BOTH the deficit and the rotation cursor persist across
        drains — a budget that exhausts mid-rotation resumes at the next
        tenant on the following drain, so repeated budgeted ticks share
        capacity by weight instead of starving tenants late in
        registration order.  Deficit resets when a tenant's queue
        empties, so an idle tenant cannot bank unbounded credit.
        """
        out: list[QueueEntry] = []

        def room() -> bool:
            return budget is None or len(out) < budget

        while self._priority and room():
            out.append(self._priority.popleft())

        while room() and any(self._queues[t] for t in self._tenants):
            tenant = self._tenants[self._cursor % len(self._tenants)]
            # advance BEFORE serving: if the budget exhausts on this
            # tenant (it already got its credit), the next drain resumes
            # at the following one
            self._cursor = (self._cursor + 1) % len(self._tenants)
            q = self._queues[tenant]
            if not q:
                continue  # idle tenants earn no credit
            # with sub-unit weights a visit may only accrue credit; the
            # loop converges because deficit grows monotonically
            self._deficit[tenant] += self.quantum * self._weights[tenant]
            while q and self._deficit[tenant] >= 1.0 and room():
                out.append(self._pop(tenant))
                self._deficit[tenant] -= 1.0
            if not q:
                self._deficit[tenant] = 0.0  # standard DRR reset
        return out

    # -- observability ---------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._priority) + sum(len(q) for q in self._queues.values())

    @property
    def queued_bins(self) -> int:
        """Distinct user-lane (tenant, bin) pairs currently queued."""
        return len(self._bin_counts)

    def pending_for(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q is not None else 0

    def deficits(self) -> dict[str, float]:
        """Per-tenant DRR deficit balances (copy) — the fairness gauge a
        dashboard watches: a persistently high deficit means the tenant
        keeps earning credit it cannot spend inside the tick budget."""
        return dict(self._deficit)
