"""Environment-adaptive re-partitioning (paper §3.2, Fig. 1).

The paper's workflow: profile once, partition, then *monitor* the mobile
environment (bandwidth, cloud speed); when drift exceeds a threshold,
re-partition with the new parameters.  Here the same loop drives
re-placement across accelerator tiers: the network profiler's bandwidth
estimate and the tier speed ratio F play the paper's roles, and
"re-partition" maps to re-running MCOP.  Elastic events (chip loss) enter
the same path: they change the tier compute capacity, i.e. F.

Hysteresis: re-partitioning is itself a cost (recompilation/resharding in
our setting; process migration in the paper's), so the controller only
acts on *relative* drift above ``threshold`` and enforces a cooldown of
``min_interval`` environment updates between repartitions.

Throughput: :meth:`AdaptiveController.sweep` is the batched entry point.
Repartition decisions depend only on the environment trace (drift +
cooldown), never on solver output, so a sweep can decide every step up
front, solve all repartition points in ONE ``mcop_batch`` dispatch, and
serve repeats from a :class:`~repro_torch.core.placement_cache.PlacementCache`
keyed on quantized environment bins.  With ``cache=None`` the sweep is
bit-identical to calling :meth:`observe` per environment.

Serving scale: where :meth:`AdaptiveController.sweep` batches one
controller across *time*, the :class:`repro_torch.service.broker.OffloadBroker`
batches many controllers across *users* — per-user
:class:`repro_torch.service.session.BrokerSession`s drive this controller's
:meth:`~AdaptiveController.begin_step` / :meth:`~AdaptiveController.commit_step`
split and route the solves through the broker's coalesced per-tick
``mcop_batch`` dispatches and shared persistent cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import baselines, pricing
from repro_torch.core.cost_models import AppProfile, CostModel, Environment, offloading_gain
from repro_torch.core.graph import WCG
from repro_torch.core.mcop import MCOPResult, mcop, solve_envs
from repro_torch.core.placement_cache import PlacementCache

__all__ = [
    "EnvironmentDrift",
    "AdaptiveController",
    "AdaptationEvent",
    "drift_exceeded_arrays",
]


def drift_exceeded_arrays(
    anchor_up,
    anchor_down,
    anchor_speedup,
    up,
    down,
    speedup,
    threshold: float,
):
    """Vectorized drift test over K (anchor, observation) pairs.

    The single place the relative-drift comparison lives: the scalar
    :meth:`EnvironmentDrift.exceeded_between` is literally a batch of
    one over this function, and the batched session engine
    (``repro_torch.core.session_batch``) runs it over all active sessions at
    once — the two paths can never disagree about a drift boundary.

    Written against the array namespace of its inputs (numpy arrays or
    torch tensors), so it can also run on a device; the session tick
    keeps it on host numpy float64 because the decision must stay
    bit-identical to the scalar controller.
    Returns a (k,) bool array: relative drift of bandwidth (either
    direction) or speedup strictly above ``threshold``.
    """
    if isinstance(up, torch.Tensor):

        def rel(new, old):
            return (new - old).abs() / old.abs().clamp_min(1e-30)

    else:

        def rel(new, old):
            return np.abs(new - old) / np.maximum(np.abs(old), 1e-30)

    return (
        (rel(up, anchor_up) > threshold)
        | (rel(down, anchor_down) > threshold)
        | (rel(speedup, anchor_speedup) > threshold)
    )


@dataclasses.dataclass
class AdaptationEvent:
    step: int
    env: Environment
    result: MCOPResult
    partial_cost: float
    no_offload_cost: float
    full_offload_cost: float
    gain: float
    repartitioned: bool
    cache_hit: bool = False


class EnvironmentDrift:
    """Tracks relative drift of the (B, F) environment since last partition."""

    def __init__(self, threshold: float = 0.10):
        self.threshold = threshold
        self._anchor: Environment | None = None

    def anchor(self, env: Environment) -> None:
        self._anchor = env

    def exceeded(self, env: Environment) -> bool:
        if self._anchor is None:
            return True
        return self.exceeded_between(self._anchor, env, self.threshold)

    @staticmethod
    def exceeded_between(
        anchor: Environment, env: Environment, threshold: float
    ) -> bool:
        """Stateless drift test — also used by the batched sweep's decision
        pre-pass, which simulates anchor updates without mutating state.

        A batch of one over :func:`drift_exceeded_arrays` (IEEE-identical
        to the historical scalar expression), so the per-object and
        batched-session paths share one drift boundary."""
        return bool(
            drift_exceeded_arrays(
                np.float64(anchor.bandwidth_up),
                np.float64(anchor.bandwidth_down),
                np.float64(anchor.speedup),
                np.float64(env.bandwidth_up),
                np.float64(env.bandwidth_down),
                np.float64(env.speedup),
                threshold,
            )
        )


class AdaptiveController:
    """Fig. 1 loop: (re-)partition when the monitored environment drifts.

    Parameters:
      profile:     program-profiler output (environment-independent).
      cost_model:  which objective (time / energy / weighted).
      threshold:   relative drift that triggers re-partitioning.
      min_interval: cooldown in observe() calls between repartitions.
      backend:     MCOP backend: "reference", "torch" or "cuda" for
                   :meth:`observe`; :meth:`sweep` also takes "cuda_fused".
      device:      where the device backends run (default needs a GPU;
                   the reference backend never touches it).
      cache:       optional PlacementCache; repartitions whose quantized
                   environment was solved before reuse the cached mask
                   (re-priced at the exact current environment).  Share one
                   cache across controllers that partition the same profile.
    """

    def __init__(
        self,
        profile: AppProfile,
        cost_model: CostModel,
        *,
        threshold: float = 0.10,
        min_interval: int = 1,
        backend: str = "reference",
        cache: PlacementCache | None = None,
        device: str | torch.device = "cuda",
    ):
        self.profile = profile
        self.cost_model = cost_model
        self.drift = EnvironmentDrift(threshold)
        self.min_interval = min_interval
        self.backend = backend
        self.device = device
        self.cache = cache
        self._steps_since = 10**9
        self._step = 0
        self._current: MCOPResult | None = None
        # decision-level flag: a partition exists or has been *scheduled*
        # (begin_step may run ticks before the deferred solve commits)
        self._has_partition = False
        self.history: list[AdaptationEvent] = []

    # ------------------------------------------------------------------
    def _clamp(self, g: WCG, candidate: MCOPResult) -> MCOPResult:
        """Paper §4.3: only partition when beneficial (shared clamp)."""
        return baselines.clamp_no_offloading(g, candidate)

    # -- decision-state checkpointing (shared with BrokerSession) ------
    def checkpoint_decision(self) -> tuple:
        """Snapshot the drift/cooldown decision state before a step.

        Pair with :meth:`rollback_decision` when the solve that
        :meth:`begin_step` scheduled never lands (solver failure,
        broker backpressure rejection) — used by :meth:`observe`'s own
        containment and by ``BrokerSession``.
        """
        return (self.drift._anchor, self._steps_since, self._has_partition)

    def rollback_decision(self, state: tuple) -> None:
        """Undo :meth:`begin_step`'s decision effects after a failed step.

        The step still happened (the clock advanced; the cooldown counts
        it) but no partition was installed, so the next observation
        retries instead of serving a placement that never arrived.
        """
        anchor, steps_since, had_partition = state
        self.drift._anchor = anchor
        self._steps_since = steps_since + 1
        self._has_partition = had_partition

    def _reprice(self, g: WCG, mask: np.ndarray) -> MCOPResult:
        """A cached mask is re-priced at the exact current WCG and clamped
        (shared with the broker via :func:`baselines.reprice_clamped`) —
        costs stay honest even though the placement came from a same-bin
        neighbor."""
        return baselines.reprice_clamped(g, mask)

    def _repartition_due(self, env: Environment) -> bool:
        return not self._has_partition or (
            self.drift.exceeded(env) and self._steps_since >= self.min_interval
        )

    def _emit(
        self,
        g: WCG | None,
        env: Environment,
        repartitioned: bool,
        cache_hit: bool,
        step: int | None = None,
        priced: tuple[float, float, float] | None = None,
    ) -> AdaptationEvent:
        """Record one event.

        ``priced`` is the precomputed ``(partial, no_offload,
        full_offload)`` triple when the caller already priced the whole
        trace in one batched evaluation (:meth:`sweep` passes ``g=None``
        then); the serial path evaluates the three numbers on ``g`` —
        bit-identical to one row of the batched report (see
        ``repro_torch.core.pricing``).
        """
        assert self._current is not None
        # Cost of the *current* placement under the *new* environment: if we
        # chose not to repartition, we still pay today's prices.
        if priced is None:
            assert g is not None
            partial = g.total_cost(self._current.local_mask)
            no_off = baselines.no_offloading(g).cost
            full = baselines.full_offloading(g).cost
        else:
            partial, no_off, full = priced
        event = AdaptationEvent(
            step=self._step if step is None else step,
            env=env,
            result=self._current,
            partial_cost=partial,
            no_offload_cost=no_off,
            full_offload_cost=full,
            gain=offloading_gain(no_off, partial),
            repartitioned=repartitioned,
            cache_hit=cache_hit,
        )
        self.history.append(event)
        return event

    # ------------------------------------------------------------------
    def begin_step(self, env: Environment) -> tuple[WCG, bool]:
        """Advance the loop clock and take the repartition decision.

        The drift/cooldown decision never depends on solver output, so
        its state effects (anchor move, cooldown reset) apply
        immediately.  That split is what lets an
        :class:`~repro_torch.service.broker.OffloadBroker` defer the solve to
        a later coalesced tick: callers pair this with
        :meth:`commit_step` once the placement is available.  Returns
        the WCG priced at ``env`` and whether a repartition is due.
        """
        self._step += 1
        self._steps_since += 1
        g = self.cost_model.build(self.profile, env)
        due = self._repartition_due(env)
        if due:
            self.drift.anchor(env)
            self._steps_since = 0
            self._has_partition = True
        return g, due

    def commit_step(
        self,
        g: WCG,
        env: Environment,
        candidate: MCOPResult | None,
        *,
        repartitioned: bool,
        cache_hit: bool = False,
        step: int | None = None,
    ) -> AdaptationEvent:
        """Install the resolved placement (if any) and emit the event.

        ``candidate`` must already be clamped (paper §4.3) and priced for
        ``g`` — :meth:`_resolve` and the broker both guarantee this.
        Deferred callers (broker sessions committing a backlog after a
        tick) pass the ``step`` number captured at :meth:`begin_step`
        time so events carry the observation's own step, not the latest
        clock value.
        """
        if repartitioned:
            assert candidate is not None
            self._current = candidate
        return self._emit(g, env, repartitioned, cache_hit, step=step)

    def _resolve(self, g: WCG, env: Environment) -> tuple[MCOPResult, bool]:
        """Cache-or-solve for one repartition point (serial path)."""
        if self.cache is not None:
            mask = self.cache.get(env, expected_n=g.n)
            if mask is not None:
                return self._reprice(g, mask), True
        candidate = self._clamp(
            g, mcop(g, backend=self.backend, device=self.device)
        )
        if self.cache is not None:
            self.cache.put(env, candidate.local_mask)
        return candidate, False

    def observe(self, env: Environment) -> AdaptationEvent:
        """Feed one environment measurement; repartition if warranted."""
        checkpoint = self.checkpoint_decision()
        g, due = self.begin_step(env)
        if not due:
            return self.commit_step(g, env, None, repartitioned=False)
        try:
            candidate, cache_hit = self._resolve(g, env)
        except BaseException:
            # a solver failure must not corrupt the loop: undo the decision
            # effects so the next observe() retries instead of serving a
            # placement that never arrived
            self.rollback_decision(checkpoint)
            raise
        return self.commit_step(
            g, env, candidate, repartitioned=True, cache_hit=cache_hit
        )

    # ------------------------------------------------------------------
    def sweep(self, envs: Sequence[Environment]) -> list[AdaptationEvent]:
        """Batched Fig.-1 loop: one fused ``solve_envs`` dispatch per sweep.

        Semantics match calling :meth:`observe` per environment
        (bit-identical events when ``cache is None``), but all
        repartition points are solved together and the whole trace is
        priced together: pass 1 replays the drift/cooldown decision
        sequence (which never depends on solver output), pass 2 resolves
        each repartition from the cache or the fused build+solve dispatch
        (WCG construction happens on the device, right before the
        solver), pass 3 prices every step — current placement,
        no-offload and full-offload baselines, stale-placement repricing
        and the §4.3 clamps — in ONE
        :func:`repro_torch.core.pricing.price_batch` evaluation, and pass 4
        emits events from the report.

        Exact cache-counter parity with the serial loop assumes the cache
        capacity exceeds the number of distinct environment bins in one
        sweep (all lookups happen before the batch's stores, so a cache
        small enough to evict *within* a sweep sees slightly fewer misses
        than serial observe would).  The default capacity (4096) is far
        above any realistic per-sweep bin count.
        """
        envs = list(envs)
        # ---- pass 1: decide repartition steps without solving ----------
        steps_since = self._steps_since
        anchor = self.drift._anchor
        have_current = self._has_partition
        decisions: list[bool] = []
        for env in envs:
            steps_since += 1
            exceeded = anchor is None or EnvironmentDrift.exceeded_between(
                anchor, env, self.drift.threshold
            )
            repart = (not have_current) or (
                exceeded and steps_since >= self.min_interval
            )
            decisions.append(repart)
            if repart:
                anchor = env
                steps_since = 0
                have_current = True

        # ---- pass 2: resolve each repartition (cache or fused solve) ---
        # One vectorized host build (for exact f64 pricing/repricing) in
        # place of K per-environment Python constructions; rows are
        # bit-identical to cost_model.build(profile, env).
        batch = self.cost_model.build_batch(self.profile, envs)
        # Vectorized §7.1 all-local baselines for the whole sweep.  These
        # also drive the §4.3 clamp of solved candidates, so no per-step
        # baseline evaluation remains anywhere in the sweep.
        no_off_costs = np.asarray(batch.w_local).sum(axis=-1)
        # per repartition step: ("mask", mask) — cache hit; ("solve", slot)
        # — own batched solve; ("reuse", slot) — same-bin reuse in-sweep
        source: dict[int, tuple] = {}
        solve_steps: list[int] = []
        pending: dict[tuple, int] = {}  # quantized key -> solve slot
        for i, env in enumerate(envs):
            if not decisions[i]:
                continue
            if self.cache is None:
                source[i] = ("solve", len(solve_steps))
                solve_steps.append(i)
                continue
            key = self.cache.key(env)
            mask = self.cache.lookup(key, expected_n=self.profile.n)
            if mask is not None:
                self.cache.record(True)
                source[i] = ("mask", mask)
            elif key in pending:
                # an earlier step this sweep already scheduled this bin; in
                # the serial loop its put() would have made this a hit
                self.cache.record(True)
                source[i] = ("reuse", pending[key])
            else:
                self.cache.record(False)
                slot = len(solve_steps)
                solve_steps.append(i)
                pending[key] = slot
                source[i] = ("solve", slot)
        # the misses flush through the fused build+solve path: one
        # dispatch constructs their WCGs on the device and runs Stoer–Wagner
        solved = (
            solve_envs(
                self.profile,
                self.cost_model,
                [envs[i] for i in solve_steps],
                backend=self.backend,
                device=self.device,
            )
            if solve_steps
            else []
        )
        clamped_solved = [
            baselines.clamp_no_offloading_priced(r, float(no_off_costs[solve_steps[s]]))
            for s, r in enumerate(solved)
        ]
        if self.cache is not None:
            for key, slot in pending.items():
                self.cache.store(key, clamped_solved[slot].local_mask)

        # ---- pass 3: ONE fused pricing evaluation, then emit -----------
        # Simulate the mask the controller will hold at every step.  A
        # cache/reuse repartition is repriced under its exact current WCG
        # and §4.3-clamped, but the clamp depends on the repriced cost —
        # which comes out of the same batched evaluation.  So each row
        # carries the *candidate* mask plus the row index whose clamp
        # decision governs it, and the select below resolves the priced
        # cost to the no-offloading number exactly when that governing
        # step clamped (the placement is all-local from then on).
        k, n = len(envs), self.profile.n
        masks = np.ones((k, batch.m), dtype=bool)
        governs: list[int | None] = [None] * k
        cur_mask = (
            np.asarray(self._current.local_mask, dtype=bool)
            if self._current is not None
            else None
        )
        cur_govern: int | None = None
        for i in range(k):
            if decisions[i]:
                kind, payload = source[i]
                if kind == "solve":
                    cur_mask = clamped_solved[payload].local_mask
                    cur_govern = None  # already clamped in pass 2
                else:  # "mask" (cache hit) / "reuse" (in-sweep follower)
                    cur_mask = np.asarray(
                        payload
                        if kind == "mask"
                        else clamped_solved[payload].local_mask,
                        dtype=bool,
                    )
                    cur_govern = i
            assert cur_mask is not None  # decisions guarantee a partition
            governs[i] = cur_govern
            masks[i, :n] = cur_mask
        report = pricing.price_batch(batch, masks)
        clamped = report.no_offload_cost < report.partial_cost  # §4.3, strict

        # ---- pass 4: emit events, updating state exactly like observe --
        events: list[AdaptationEvent] = []
        for i, env in enumerate(envs):
            self._step += 1
            self._steps_since += 1
            cache_hit = False
            j = governs[i]
            take_no_off = j is not None and bool(clamped[j])
            partial = float(
                report.no_offload_cost[i] if take_no_off else report.partial_cost[i]
            )
            if decisions[i]:
                kind, payload = source[i]
                if kind == "solve":
                    self._current = clamped_solved[payload]
                else:
                    # reprice through the fused report (shared §4.3 clamp)
                    self._current = baselines.reprice_clamped_priced(
                        float(report.partial_cost[i]),
                        float(report.no_offload_cost[i]),
                        masks[i, :n],
                    )
                    cache_hit = True
                self.drift.anchor(env)
                self._steps_since = 0
                self._has_partition = True
            events.append(
                self._emit(
                    None,
                    env,
                    decisions[i],
                    cache_hit,
                    priced=(
                        partial,
                        float(report.no_offload_cost[i]),
                        float(report.full_offload_cost[i]),
                    ),
                )
            )
        return events

    @property
    def placement(self) -> MCOPResult:
        if self._current is None:
            raise RuntimeError("no partition computed yet; call observe()")
        return self._current
