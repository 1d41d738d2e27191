"""Array-native session engine: K adaptive sessions as stacked arrays.

The *solver* side of the serving tier is array-native — one
``solve_envs`` flush per tick, one ``price_batch`` for telemetry — but a
user modelled as a Python :class:`~repro_torch.service.session.BrokerSession`
wrapping an :class:`~repro_torch.core.adaptive.AdaptiveController` keeps a
broker tick O(users) interpreted work above the solver.  This module
holds the session *state itself* in arrays:

* :class:`SessionBatch` — a dataclass of numpy arrays holding, for K
  sessions: the drift anchors (the environment at the last repartition),
  current placement masks, installed cut values, the per-session step
  clock and repartition-cooldown counters, and activity flags (a fixed
  capacity of slots; Poisson arrivals / geometric churn activate and
  reset them — see ``repro_torch.service.workload.TrafficGenerator``).
* :meth:`SessionBatch.begin_step` — the vectorized Fig.-1 decision: one
  pass of array arithmetic advances every session's clock, runs the
  shared drift test (:func:`repro_torch.core.adaptive.drift_exceeded_arrays`
  — literally the same function the scalar controller calls) and moves
  the anchors of every session whose repartition is due.
* :func:`tick_sessions` / :meth:`SessionBatch.commit_step` — one tick
  over all K sessions: (a) one vectorized cache probe on quantized keys
  (:meth:`~repro_torch.core.placement_cache.EnvQuantizer.keys_batch`), (b) ONE
  ``solve_envs`` flush for the distinct-bin misses, (c) ONE fused
  ``price_batch`` pricing every session's final mask, baselines and
  §4.3 clamps together.

The decision/drift arithmetic stays host numpy float64 on purpose: the
parity contract below demands bit-identity with the scalar controller,
and the device tiers are float32.  (:func:`drift_exceeded_arrays` is
namespace-polymorphic and :meth:`SessionBatch.to` moves the state onto a
torch device, so a deployment can run the decision pass there without
touching this module.)

Parity contract (asserted by ``tests/test_session_batch.py`` with
``==``, not approx): one :func:`tick_sessions` produces events,
placements and prices **bit-identical** to K
:class:`~repro_torch.service.session.BrokerSession` objects observing the same
environments in session-index order through an
:class:`~repro_torch.service.broker.OffloadBroker` sharing the same cache —
hits probed before any store of the tick, first miss per quantized bin
becomes the representative solve, same-bin followers repriced under
their exact own graph, §4.3 clamps applied through the shared
``baselines`` helpers.

Failure containment differs from the broker deliberately: the broker
re-queues unresolved requests, while a batched tick is atomic — if the
solve flush raises, all decision state is restored to its pre-tick
checkpoint (no events, no counter updates, no stores) and the caller
retries the whole tick.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import pricing
from repro_torch.core.adaptive import AdaptationEvent, drift_exceeded_arrays
from repro_torch.core.cost_models import AppProfile, CostModel, EnvArrays
from repro_torch.core.mcop import DEFAULT_BUCKETS, MCOPResult, _single_device, solve_envs
from repro_torch.core.placement_cache import PlacementCache
from repro_torch.kernels.build import KernelError
from repro_torch.obs.trace import NULL_SPAN

__all__ = ["SessionBatch", "SessionTickReport", "tick_sessions"]

# AdaptiveController's "no partition yet" cooldown sentinel: a fresh
# session is always due on its first observation.
_NEVER = 10**9

# the mutable arrays; n/threshold/min_interval are static
_LEAF_FIELDS = (
    "anchor_up",
    "anchor_down",
    "anchor_speedup",
    "placements",
    "min_cuts",
    "steps",
    "steps_since",
    "has_partition",
    "active",
)


@dataclasses.dataclass
class SessionBatch:
    """K concurrent adaptive sessions as stacked arrays.

    Attributes:
      n:            graph size (the tenant profile's vertex count).
      threshold:    relative drift that triggers re-partitioning.
      min_interval: cooldown in observations between repartitions.
      anchor_*:     (k,) f64 — environment at the last repartition (the
                    drift detector's anchor); 0.0 until one exists.
      placements:   (k, n) bool — each session's current local-mask.
      min_cuts:     (k,) f64 — installed result's cut value (NaN until a
                    partition exists).
      steps:        (k,) i64 — per-session observation clock (events
                    carry it, matching ``AdaptiveController._step``).
      steps_since:  (k,) i64 — observations since the last repartition.
      has_partition:(k,) bool — a partition exists (or none scheduled).
      active:       (k,) bool — slot is occupied by a live session.

    :meth:`checkpoint` / :meth:`restore` snapshot every array at once;
    :meth:`to` returns the same state as torch tensors on a device.
    """

    n: int
    threshold: float
    min_interval: int
    anchor_up: np.ndarray
    anchor_down: np.ndarray
    anchor_speedup: np.ndarray
    placements: np.ndarray
    min_cuts: np.ndarray
    steps: np.ndarray
    steps_since: np.ndarray
    has_partition: np.ndarray
    active: np.ndarray

    # -- construction ----------------------------------------------------
    @classmethod
    def create(
        cls,
        capacity: int,
        n: int,
        *,
        threshold: float = 0.10,
        min_interval: int = 1,
    ) -> "SessionBatch":
        """``capacity`` empty session slots for an ``n``-vertex profile."""
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if n <= 0:
            raise ValueError("graph size must be positive")
        return cls(
            n=int(n),
            threshold=float(threshold),
            min_interval=int(min_interval),
            anchor_up=np.zeros(capacity),
            anchor_down=np.zeros(capacity),
            anchor_speedup=np.zeros(capacity),
            placements=np.ones((capacity, n), dtype=bool),
            min_cuts=np.full(capacity, np.nan),
            steps=np.zeros(capacity, dtype=np.int64),
            steps_since=np.full(capacity, _NEVER, dtype=np.int64),
            has_partition=np.zeros(capacity, dtype=bool),
            active=np.zeros(capacity, dtype=bool),
        )

    @property
    def capacity(self) -> int:
        return int(self.steps.shape[0])

    @property
    def active_count(self) -> int:
        return int(np.count_nonzero(self.active))

    def _rows(self, sessions) -> np.ndarray:
        idx = np.asarray(sessions)
        if idx.dtype == bool:
            if idx.shape != (self.capacity,):
                raise ValueError(
                    f"session mask must be ({self.capacity},), got {idx.shape}"
                )
            idx = np.nonzero(idx)[0]
        return idx.astype(np.int64).reshape(-1)

    # -- churn: slot lifecycle ------------------------------------------
    def activate(self, sessions) -> None:
        """Reset the given slots (index array or (k,) bool mask) to a
        fresh session and mark them live — an arrival.  A fresh session
        has no partition, so its first observation is always due."""
        idx = self._rows(sessions)
        if idx.size == 0:
            return
        for f in ("anchor_up", "anchor_down", "anchor_speedup"):
            getattr(self, f)[idx] = 0.0
        self.placements[idx] = True
        self.min_cuts[idx] = np.nan
        self.steps[idx] = 0
        self.steps_since[idx] = _NEVER
        self.has_partition[idx] = False
        self.active[idx] = True

    def deactivate(self, sessions) -> None:
        """Mark the given slots free — a departure.  State is cleared at
        the next :meth:`activate`, so a just-departed slot stays
        inspectable until reused."""
        idx = self._rows(sessions)
        self.active[idx] = False

    def to(self, device) -> "SessionBatch":
        """The same state as torch tensors on ``device`` (dtypes kept:
        f64 anchors and cuts, i64 clocks, bool flags).  The host tick
        works on the numpy form; this is for device-side decision or
        telemetry passes."""
        return SessionBatch(
            self.n,
            self.threshold,
            self.min_interval,
            *(torch.as_tensor(getattr(self, f)).to(device) for f in _LEAF_FIELDS),
        )

    # -- atomic-tick checkpointing --------------------------------------
    def checkpoint(self) -> tuple:
        """Copies of all mutable arrays (pair with :meth:`restore`)."""
        return tuple(getattr(self, f).copy() for f in _LEAF_FIELDS)

    def restore(self, state: tuple) -> None:
        for f, a in zip(_LEAF_FIELDS, state):
            setattr(self, f, a)

    # -- the vectorized Fig.-1 decision ---------------------------------
    def begin_step(self, envs: EnvArrays) -> np.ndarray:
        """Advance every active session's clock and decide repartitions.

        One vectorized pass replicating
        :meth:`~repro_torch.core.adaptive.AdaptiveController.begin_step` per
        row: clocks advance, the shared drift test runs against the
        anchors, and every due session's anchor moves to today's
        environment with its cooldown reset.  Returns the (k,) bool
        "repartition due" mask (False on inactive slots).

        Like the scalar controller, the decision never depends on solver
        output — which is exactly what lets :func:`tick_sessions` defer
        all due sessions to one coalesced solve flush.
        """
        if envs.k != self.capacity:
            raise ValueError(
                f"envs must carry {self.capacity} rows, got {envs.k}"
            )
        act = self.active
        self.steps[act] += 1
        self.steps_since[act] += 1
        exceeded = drift_exceeded_arrays(
            self.anchor_up,
            self.anchor_down,
            self.anchor_speedup,
            np.asarray(envs.bandwidth_up, dtype=np.float64),
            np.asarray(envs.bandwidth_down, dtype=np.float64),
            np.asarray(envs.speedup, dtype=np.float64),
            self.threshold,
        )
        due = act & (
            ~self.has_partition
            | (exceeded & (self.steps_since >= self.min_interval))
        )
        self.anchor_up = np.where(due, envs.bandwidth_up, self.anchor_up)
        self.anchor_down = np.where(due, envs.bandwidth_down, self.anchor_down)
        self.anchor_speedup = np.where(due, envs.speedup, self.anchor_speedup)
        self.steps_since = np.where(due, 0, self.steps_since)
        self.has_partition = self.has_partition | due
        return due

    # -- commit ----------------------------------------------------------
    def commit_step(
        self,
        due: np.ndarray,
        final_masks: np.ndarray,
        new_min_cuts: np.ndarray,
    ) -> None:
        """Install the tick's resolved placements (due rows only).

        ``final_masks`` is the full (k, n) mask table with non-due rows
        already carrying their current placement (the form
        :func:`tick_sessions` prices), ``new_min_cuts`` likewise (k,).
        """
        self.placements = np.where(due[:, None], final_masks, self.placements)
        self.min_cuts = np.where(due, new_min_cuts, self.min_cuts)


@dataclasses.dataclass
class SessionTickReport:
    """One batched tick's outcome, as (k,)/(k, n) arrays.

    The array twin of a list of K
    :class:`~repro_torch.core.adaptive.AdaptationEvent` — at 10⁵–10⁶ sessions
    the tick never materializes Python event objects; benchmarks and
    dashboards consume the arrays, and the parity tests call
    :meth:`event` / :meth:`events` to compare individual sessions
    against the serial loop.
    """

    steps: np.ndarray            # (k,) i64 session clocks at this tick
    active: np.ndarray           # (k,) bool
    repartitioned: np.ndarray    # (k,) bool — the tick's due mask
    cache_hit: np.ndarray        # (k,) bool (followers count as hits)
    placements: np.ndarray       # (k, n) bool final masks
    min_cut: np.ndarray          # (k,) f64 installed result cut values
    partial_cost: np.ndarray     # (k,) f64 Eq.-2 price of the final mask
    no_offload_cost: np.ndarray  # (k,) f64 §7.1 all-local baseline
    full_offload_cost: np.ndarray  # (k,) f64 §7.1 baseline
    gain: np.ndarray             # (k,) f64 offloading gain
    envs: EnvArrays              # the observed environments
    hits: int                    # cache hits among due sessions
    solved: int                  # representative solves dispatched
    coalesced: int               # same-bin followers folded into a solve
    due: int                     # sessions repartitioned this tick
    device_summary: dict | None = None  # fused device telemetry (optional)
    # fault-tolerance (resilient ticks only; see tick_sessions(faults=))
    degraded: np.ndarray | None = None  # (k,) bool — rows served a fallback
    retries: int = 0             # solve-flush retries performed this tick
    faults: int = 0              # injected/observed fault events this tick
    breaker_trips: int = 0       # circuit-breaker open transitions

    @property
    def k(self) -> int:
        return int(self.steps.shape[0])

    def event(self, i: int) -> AdaptationEvent:
        """Materialize session ``i``'s tick as a scalar event (parity/
        debugging path — O(1) Python objects per call, never used by the
        hot tick)."""
        return AdaptationEvent(
            step=int(self.steps[i]),
            env=self.envs.env(i),
            result=MCOPResult(
                min_cut=float(self.min_cut[i]),
                local_mask=self.placements[i].copy(),
                phases=[],
            ),
            partial_cost=float(self.partial_cost[i]),
            no_offload_cost=float(self.no_offload_cost[i]),
            full_offload_cost=float(self.full_offload_cost[i]),
            gain=float(self.gain[i]),
            repartitioned=bool(self.repartitioned[i]),
            cache_hit=bool(self.cache_hit[i]),
        )

    def events(self, sessions=None) -> list[AdaptationEvent]:
        """Events for ``sessions`` (default: every active slot, in order)."""
        if sessions is None:
            sessions = np.nonzero(self.active)[0]
        return [self.event(int(i)) for i in np.asarray(sessions).reshape(-1)]

    def summary(self) -> dict:
        """Aggregate telemetry over active sessions (host reduction)."""
        act = self.active
        n_act = max(int(np.count_nonzero(act)), 1)
        return {
            "sessions": int(np.count_nonzero(act)),
            "repartitioned": self.due,
            "cache_hits": self.hits,
            "coalesced": self.coalesced,
            "solved": self.solved,
            "mean_partial_cost": float(self.partial_cost[act].sum() / n_act)
            if act.any()
            else 0.0,
            "mean_gain": float(self.gain[act].sum() / n_act) if act.any() else 0.0,
        }


def tick_sessions(
    batch: SessionBatch,
    envs: EnvArrays,
    *,
    profile: AppProfile,
    model: CostModel,
    cache: PlacementCache,
    backend: str = "cuda",
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = "cuda",
    device_telemetry: bool = False,
    faults=None,
    resilience=None,
    tick: int = 0,
    sleep=None,
    tracer=None,
    metrics=None,
    mesh=None,
) -> SessionTickReport:
    """One broker tick over all K sessions of ``batch``.

    The whole tick is three vectorized stages (plus O(due-sessions)
    Python for the dict-backed cache probe):

    1. **Decide + probe** — :meth:`SessionBatch.begin_step` takes every
       drift/cooldown decision in one array pass; due sessions' quantized
       keys come from one :meth:`EnvQuantizer.keys_batch` evaluation and
       probe the shared cache in session order (hits see only entries
       stored by *earlier* ticks, exactly like the broker's
       classification loop).
    2. **Solve** — first-miss-per-bin representatives flush through ONE
       :func:`~repro_torch.core.mcop.solve_envs` call; same-bin followers
       coalesce onto their representative.
    3. **Price + commit** — every session's candidate mask (current
       placement for non-due rows, cached/solved masks for due rows) is
       priced in ONE fused ``price_batch``; the §4.3 clamps resolve
       against the same report (representatives by solver cut, hits and
       followers by repriced cost — the shared ``baselines`` strictness),
       placements install, and cache counters/stores record.

    Bit-identity: with ``backend="reference"`` every event this returns
    equals the serial ``BrokerSession`` loop bitwise (see module
    docstring).  With the f32 device backends (``"torch"``, ``"cuda"``,
    ``"cuda_fused"``, run on ``device``) the *solver* may in
    principle resolve an exact cut tie differently than the broker's
    build-f64-then-cast path (same caveat as ``solve_envs``); prices are
    f64 host arithmetic either way.

    Atomic: any failure (solver error, bad environment) restores the
    batch to its pre-tick state and re-raises — no events, no counter or
    cache mutations; retry the whole tick.

    Resilient mode (``faults``/``resilience``, wired by the broker's
    :meth:`~repro_torch.service.broker.OffloadBroker.tick` when it carries a
    :class:`~repro_torch.service.resilience.ResiliencePolicy`): the solve
    flush retries with backoff under the optional circuit breaker, and
    a flush that exhausts its retries *degrades instead of raising* —
    every due miss row is served a fallback mask (stale cached bin if
    one exists, else the §4.3 all-local plan), flagged in
    ``report.degraded``, and its drift anchor is rolled back so the
    session re-partitions on the next clean tick (convergence once the
    fault storm ends, asserted by the chaos suite).  ``tick`` keys the
    deterministic injector; ``sleep`` charges backoff/latency time to
    the caller's clock.  Pricing failures still restore-and-raise (the
    broker contains them to the group).

    Observability (``tracer``/``metrics``, see ``repro_torch.obs``): when
    attached, the tick emits stage spans (drift, cache probe, solve
    flush, pricing, commit) and fault/retry/breaker/degraded events on
    the tracer, and dispatch timings on the registry.  Both default to
    ``None`` and the instrumented paths then run bit-identically to the
    uninstrumented tick — notably they never read the caller's clock.

    ``mesh`` takes ``None``/``False`` only: this package solves on one
    device, and the flush span reports ``devices=1``.
    """
    _single_device(mesh)
    if faults is not None or resilience is not None:
        # deferred: the fault vocabulary lives in the service layer
        from repro_torch.service.faults import InjectedFault, poison_envs
    attempts = resilience.retry.attempts if resilience is not None else 1
    breaker = resilience.breaker if resilience is not None else None
    n_retries = n_faults = n_trips = 0

    def _charge(seconds: float) -> None:
        if sleep is not None and seconds > 0:
            sleep(seconds)

    def _span(name: str, **attrs):
        return tracer.span(name, **attrs) if tracer is not None else NULL_SPAN

    def _event(name: str, **attrs) -> None:
        if tracer is not None:
            tracer.event(name, **attrs)

    state = batch.checkpoint()
    try:
        with _span("stage.drift", tick=tick, sessions=batch.capacity) as sp:
            due = batch.begin_step(envs)
            n = batch.n
            # one vectorized host f64 build: pricing, baselines and clamps
            # for the whole batch (rows bit-identical to cost_model.build)
            wcg_batch = model.build_batch(profile, envs)
            no_off = np.asarray(wcg_batch.w_local).sum(axis=-1)  # (k,)
            sp.set(due=int(np.count_nonzero(due)))

        # ---- stage 1: classify due sessions against the cache ----------
        due_idx = np.nonzero(due)[0]
        keys = cache.quantizer.keys_batch(envs.take(due_idx)) if due_idx.size else None
        hit_idx: list[int] = []
        hit_masks: list[np.ndarray] = []
        solve_idx: list[int] = []
        solve_keys: list[tuple] = []
        fol_idx: list[int] = []
        fol_slot: list[int] = []
        rep_slot: dict[tuple, int] = {}
        with _span("stage.cache_probe", due=int(due_idx.size)) as sp:
            for row, i in enumerate(due_idx):
                key = tuple(int(v) for v in keys[row])
                lost_load = False
                if faults is not None:
                    d = faults.decide("cache_load", tick, int(i))
                    if d.fires:
                        n_faults += 1
                        _event(
                            "fault",
                            site="cache_load",
                            kind=d.kind,
                            tick=tick,
                            index=int(i),
                        )
                        if d.kind == "latency":
                            _charge(d.delay_s)
                        else:
                            lost_load = True  # probe discarded: miss
                mask = None if lost_load else cache.lookup(key, expected_n=n)
                if mask is not None:
                    hit_idx.append(int(i))
                    hit_masks.append(mask)
                    continue
                slot = rep_slot.get(key)
                if slot is None:
                    rep_slot[key] = len(solve_idx)
                    solve_idx.append(int(i))
                    solve_keys.append(key)
                else:
                    fol_idx.append(int(i))
                    fol_slot.append(slot)
            sp.set(
                hits=len(hit_idx),
                misses=len(solve_idx),
                coalesced=len(fol_idx),
            )

        # ---- stage 2: ONE solve flush for the distinct-bin misses ------
        # Resilient mode retries the flush (injector consulted per
        # attempt; the breaker picks the effective backend for a solve on
        # the CPU and leaves it alone on a GPU); exhaustion
        # QUARANTINES the flush: every miss row degrades to a fallback
        # mask below instead of aborting the whole tick.
        solved: list | None = [] if not solve_idx else None
        on_cpu = torch.device(device).type == "cpu"
        if solve_idx:
            sub = envs.take(solve_idx)
            with _span(
                "stage.solve_flush",
                batch=len(solve_idx),
                backend=backend,
                tick=tick,
                devices=1,
            ):
                for attempt in range(attempts):
                    if attempt:
                        n_retries += 1
                        _event(
                            "retry", site="solve", attempt=attempt, tick=tick
                        )
                        _charge(resilience.retry.backoff(attempt - 1))
                    eff = (
                        breaker.backend(backend, tick, escalate=on_cpu)
                        if breaker is not None
                        else backend
                    )
                    use = sub
                    try:
                        if faults is not None:
                            d = faults.decide("solve", tick, attempt)
                            if d.fires:
                                n_faults += 1
                                _event(
                                    "fault",
                                    site="solve",
                                    kind=d.kind,
                                    tick=tick,
                                    index=attempt,
                                )
                                if d.kind == "latency":
                                    _charge(d.delay_s)
                                elif d.kind == "error":
                                    raise InjectedFault(
                                        "solve", tick, attempt
                                    )
                                else:
                                    use = poison_envs(sub)
                        out = solve_envs(
                            profile,
                            model,
                            use,
                            backend=eff,
                            buckets=buckets,
                            device=device,
                            metrics=metrics,
                            mesh=mesh,
                        )
                        if not all(np.isfinite(r.min_cut) for r in out):
                            raise RuntimeError(
                                "non-finite min_cut from solve flush"
                            )
                        if breaker is not None:
                            breaker.record_success(eff)
                        solved = out
                        break
                    except KernelError:
                        raise  # a kernel that cannot run is never degraded
                    except Exception:
                        if breaker is not None and breaker.record_failure(
                            eff, tick
                        ):
                            n_trips += 1
                            _event(
                                "breaker_trip", backend=eff, tick=tick
                            )
                        if resilience is None:
                            raise
        deg_idx: list[int] = []
        if solved is None:
            # flush quarantined: reps AND their followers fall back to
            # the stale cached bin (uncounted probe) or the §4.3
            # all-local plan; their drift anchors roll back after commit
            # so each retries on the next clean tick
            deg_idx = solve_idx + fol_idx
            deg_keys = solve_keys + [solve_keys[s] for s in fol_slot]
            deg_masks = []
            for key in deg_keys:
                m = cache.lookup(key, expected_n=n)
                deg_masks.append(
                    np.ones(n, dtype=bool) if m is None else m
                )
            solve_idx, solve_keys, fol_idx, fol_slot = [], [], [], []
            solved = []
            _event("degraded", sessions=len(deg_idx), tick=tick)
        solver_cuts = np.array([r.min_cut for r in solved], dtype=np.float64)
        solved_masks = (
            np.stack([r.local_mask for r in solved]).astype(bool)
            if solved
            else np.zeros((0, n), dtype=bool)
        )
        # §4.3 clamp of representatives: strictly cheaper all-local plan
        # wins, judged against the solver's own cut value (the comparison
        # clamp_no_offloading_priced applies)
        rep_clamped = (
            no_off[solve_idx] < solver_cuts
            if solve_idx
            else np.zeros(0, dtype=bool)
        )

        # ---- stage 3: ONE fused pricing pass over candidate masks ------
        rows = batch.placements.copy()
        sel = np.zeros(batch.capacity, dtype=bool)  # rows clamped by price
        if hit_idx:
            rows[hit_idx] = np.stack(hit_masks)
            sel[hit_idx] = True
        if solve_idx:
            rows[solve_idx] = np.where(
                rep_clamped[:, None], True, solved_masks
            )
        if fol_idx:
            # followers carry their representative's mask: the FINAL
            # (clamped) one — all-local when the rep clamped, whose price
            # is exactly the no-offload baseline, so the select below is
            # a no-op for them (matching the broker's explicit all-local
            # follower reply) — the RAW solved mask otherwise.
            slots = np.asarray(fol_slot)
            rows[fol_idx] = np.where(
                rep_clamped[slots][:, None], True, solved_masks[slots]
            )
            sel[fol_idx] = True
        if deg_idx:
            # quarantined rows price exactly like hit rows: the shared
            # §4.3 select below clamps a fallback that is worse than
            # all-local onto the all-ones plan
            rows[deg_idx] = np.stack(deg_masks)
            sel[deg_idx] = True
        report = None
        with _span("stage.pricing", rows=batch.capacity, tick=tick):
            for attempt in range(attempts):
                if attempt:
                    n_retries += 1
                    _event(
                        "retry", site="pricing", attempt=attempt, tick=tick
                    )
                    _charge(resilience.retry.backoff(attempt - 1))
                try:
                    if faults is not None:
                        d = faults.decide("pricing", tick, attempt)
                        if d.fires:
                            n_faults += 1
                            _event(
                                "fault",
                                site="pricing",
                                kind=d.kind,
                                tick=tick,
                                index=attempt,
                            )
                            if d.kind == "latency":
                                _charge(d.delay_s)
                            else:
                                raise InjectedFault("pricing", tick, attempt)
                    if metrics is not None:
                        with metrics.timer("price_batch_duration_s"):
                            report = pricing.price_batch(wcg_batch, rows)
                    else:
                        report = pricing.price_batch(wcg_batch, rows)
                    break
                except Exception:
                    if resilience is None:
                        raise
        if report is None:
            # pricing exhausted its retries: without prices no honest
            # event can be emitted — restore and let the broker contain
            # the failure to this group (staged observation retries)
            raise RuntimeError("pricing exhausted retries; tick aborted")
        partial = np.asarray(report.partial_cost, dtype=np.float64)
        # shared §4.3 strictness: hits/followers whose all-local baseline
        # is strictly cheaper flip to the all-ones plan (reprice_clamped)
        clamped = sel & (no_off < partial)
        rows[clamped] = True
        partial = np.where(clamped, no_off, partial)

        new_min_cuts = batch.min_cuts.copy()
        sel_rows = np.nonzero(sel)[0]
        # hit/follower result cut = repriced (possibly clamped) cost,
        # exactly reprice_clamped_priced's min_cut
        new_min_cuts[sel_rows] = partial[sel_rows]
        if solve_idx:
            # representative result keeps the solver's own cut value
            # unless clamped to the baseline (clamp_no_offloading_priced)
            new_min_cuts[solve_idx] = np.where(
                rep_clamped, no_off[solve_idx], solver_cuts
            )
    except BaseException:
        batch.restore(state)
        raise

    # ---- success: counters, stores, state install (infallible) ---------
    # degraded rows count as misses (they did miss; the fallback is a
    # served answer, not a cache hit) and never store
    with _span("stage.commit", stores=len(solve_idx), tick=tick):
        cache.record_many(
            hits=len(hit_idx), misses=len(solve_idx) + len(deg_idx)
        )
        cache.record_many(hits=len(fol_idx))  # followers hit rep's store
        for slot, i in enumerate(solve_idx):
            if faults is not None:
                d = faults.decide("cache_store", tick, slot)
                if d.fires:
                    n_faults += 1
                    _event(
                        "fault",
                        site="cache_store",
                        kind=d.kind,
                        tick=tick,
                        index=slot,
                    )
                    if d.kind == "latency":
                        _charge(d.delay_s)
                    else:
                        continue  # store dropped: the bin re-solves later
            cache.store(solve_keys[slot], rows[i])
        batch.commit_step(due, rows, new_min_cuts)
    degraded_rows = None
    if deg_idx:
        # roll the quarantined sessions' decision state back to the
        # pre-tick checkpoint (clock keeps ticking): the drift test
        # re-fires next tick, so they converge once faults stop
        idx = np.asarray(deg_idx, dtype=np.int64)
        chk = dict(zip(_LEAF_FIELDS, state))
        for f in (
            "anchor_up",
            "anchor_down",
            "anchor_speedup",
            "steps_since",
            "has_partition",
        ):
            getattr(batch, f)[idx] = chk[f][idx]
        degraded_rows = np.zeros(batch.capacity, dtype=bool)
        degraded_rows[idx] = True

    cache_hit = np.zeros(batch.capacity, dtype=bool)
    cache_hit[hit_idx] = True
    cache_hit[fol_idx] = True
    tick_report = SessionTickReport(
        steps=batch.steps.copy(),
        active=batch.active.copy(),
        repartitioned=due,
        cache_hit=cache_hit,
        placements=rows,
        min_cut=batch.min_cuts.copy(),
        partial_cost=partial,
        no_offload_cost=no_off,
        full_offload_cost=np.asarray(report.full_offload_cost, dtype=np.float64),
        gain=pricing.vector_gain(no_off, partial),
        envs=envs,
        hits=len(hit_idx),
        solved=len(solve_idx),
        coalesced=len(fol_idx),
        due=int(due_idx.size),
        degraded=degraded_rows,
        retries=n_retries,
        faults=n_faults,
        breaker_trips=n_trips,
    )
    if device_telemetry:
        tick_report.device_summary = pricing.device_price_summary(
            profile, model, envs, rows, active=batch.active, device=device
        )
    return tick_report
