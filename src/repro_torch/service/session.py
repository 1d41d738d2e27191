"""Per-user adaptive sessions driven through a shared OffloadBroker.

A :class:`BrokerSession` is one user's paper-Fig.-1 loop
(:class:`~repro_torch.core.adaptive.AdaptiveController`) with the *solve*
routed through an :class:`~repro_torch.service.broker.OffloadBroker` instead
of a private ``mcop()`` call.  The controller's
``begin_step``/``commit_step`` split makes this exact: the drift +
cooldown decision (which never depends on solver output) is taken
synchronously at :meth:`BrokerSession.observe`, the placement arrives at
the broker's next tick, and :meth:`BrokerSession.drain` commits events
in observation order — bit-identical to a serial ``observe()`` loop over
controllers sharing one :class:`~repro_torch.core.placement_cache.PlacementCache`
(see the broker↔serial parity tests).

:class:`BatchSessionGroup` is the array-native sibling: K sessions of a
tenant held as one :class:`~repro_torch.core.session_batch.SessionBatch`
and resolved by the broker in ONE vectorized tick — the path the
10⁵–10⁶-user scale benchmarks ride.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core.adaptive import AdaptationEvent, AdaptiveController
from repro_torch.core.cost_models import EnvArrays, Environment
from repro_torch.core.graph import WCG
from repro_torch.core.session_batch import SessionBatch, SessionTickReport, tick_sessions
from repro_torch.service.broker import OffloadBroker, PlacementFuture

__all__ = ["BrokerSession", "BatchSessionGroup"]


@dataclasses.dataclass
class _PendingStep:
    g: WCG
    env: Environment
    due: bool
    future: PlacementFuture | None  # None when no repartition was due
    step: int  # controller step at observation time (events carry this)


class BrokerSession:
    """One tenant user: observations in, broker-resolved events out.

    The wrapped controller carries ``cache=None`` — the shared cache
    lives in the broker's tenant and is consulted inside the tick, so
    N sessions of one tenant get the multi-user reuse win without each
    holding cache state.
    """

    def __init__(
        self,
        broker: OffloadBroker,
        tenant: str,
        *,
        threshold: float = 0.10,
        min_interval: int = 1,
    ):
        t = broker.tenant(tenant)
        if t.profile is None:
            raise ValueError(f"tenant {tenant!r} has no profile/cost model")
        self.broker = broker
        self.tenant = tenant
        self.controller = AdaptiveController(
            t.profile,
            t.cost_model,
            threshold=threshold,
            min_interval=min_interval,
            backend=broker.backend,
            cache=None,
            device=broker.device,
        )
        self._pending: deque[_PendingStep] = deque()

    def observe(self, env: Environment) -> None:
        """Feed one measurement; enqueues a solve if repartition is due.

        The resulting event materializes at :meth:`drain` after the
        broker's next :meth:`~repro_torch.service.broker.OffloadBroker.tick`.

        If the broker rejects the solve outright (backpressure past the
        scheduler's queued-bin cap), the step degrades to a
        non-repartition: the decision effects are rolled back — exactly
        the containment :meth:`~repro_torch.core.adaptive.AdaptiveController.observe`
        applies on solver failure — so the drift detector retries at the
        next observation, and :meth:`drain` emits the step priced under
        the *current* placement.  A rejection before any placement
        exists raises: the session cannot run without one.
        """
        ctl = self.controller
        checkpoint = ctl.checkpoint_decision()
        g, due = ctl.begin_step(env)
        future = self.broker.submit_graph(self.tenant, g, env) if due else None
        if future is not None and future.done and future.result.rejected:
            ctl.rollback_decision(checkpoint)
            if ctl._current is None:
                raise RuntimeError(
                    f"broker rejected the first placement request of tenant "
                    f"{self.tenant!r} (backpressure); session has no placement "
                    "to fall back on — retry after a tick drains the queue"
                )
            due, future = False, None  # keep the current placement
        self._pending.append(
            _PendingStep(g, env, due, future, ctl._step)
        )

    def drain(self) -> list[AdaptationEvent]:
        """Commit every resolved observation, in order; stops at the
        first one still waiting on a future tick."""
        events: list[AdaptationEvent] = []
        while self._pending:
            step = self._pending[0]
            if step.due and not step.future.done:
                break
            self._pending.popleft()
            if step.due:
                reply = step.future.result
                event = self.controller.commit_step(
                    step.g,
                    step.env,
                    reply.result,
                    repartitioned=True,
                    cache_hit=reply.cache_hit,
                    step=step.step,
                )
            else:
                event = self.controller.commit_step(
                    step.g, step.env, None, repartitioned=False, step=step.step
                )
            events.append(event)
        return events

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def history(self) -> list[AdaptationEvent]:
        return self.controller.history


class BatchSessionGroup:
    """K array-native sessions of one tenant, ticked inside the broker.

    The 10⁵–10⁶-user replacement for K :class:`BrokerSession` objects:
    session state lives in one :class:`~repro_torch.core.session_batch.SessionBatch`
    of stacked arrays, a whole tick's observations arrive as one
    :class:`~repro_torch.core.cost_models.EnvArrays`, and the broker's
    :meth:`~repro_torch.service.broker.OffloadBroker.tick` resolves the group
    with ONE :func:`~repro_torch.core.session_batch.tick_sessions` call — same
    shared tenant cache, same coalescing/§4.3 semantics, bit-identical
    events (see the session-batch parity tests).

    Protocol per tick: :meth:`observe` stages the environments (applying
    arrivals/departures first), ``broker.tick()`` runs the batched tick,
    :meth:`drain` returns the accumulated
    :class:`~repro_torch.core.session_batch.SessionTickReport` objects.
    Created via :meth:`OffloadBroker.register_batch`.
    """

    def __init__(
        self,
        broker: OffloadBroker,
        tenant: str,
        *,
        capacity: int,
        threshold: float = 0.10,
        min_interval: int = 1,
        device_telemetry: bool = False,
    ):
        t = broker.tenant(tenant)
        if t.profile is None:
            raise ValueError(f"tenant {tenant!r} has no profile/cost model")
        self.broker = broker
        self.tenant = tenant
        self.device_telemetry = device_telemetry
        self.batch = SessionBatch.create(
            capacity,
            t.profile.n,
            threshold=threshold,
            min_interval=min_interval,
        )
        self._staged: EnvArrays | None = None
        self._reports: deque[SessionTickReport] = deque()

    def observe(
        self,
        envs,
        *,
        arrived=None,
        departed=None,
    ) -> None:
        """Stage one tick of observations for all ``capacity`` slots.

        Args:
          envs:     :class:`EnvArrays` with one row per slot (inactive
                    rows carry placeholders), or a sequence of
                    Environments.
          arrived:  slots (index array or bool mask) activated this tick
                    — reset to fresh sessions before the tick runs.
          departed: slots deactivated this tick (applied before
                    ``arrived``, so a slot can turn over in one tick).

        The staged tick runs at the broker's next
        :meth:`~repro_torch.service.broker.OffloadBroker.tick`; staging twice
        without a tick in between is an error (one batch IS one tick's
        worth of observations).
        """
        if self._staged is not None:
            raise RuntimeError(
                f"batch group {self.tenant!r} already has a staged "
                "observation; run broker.tick() first"
            )
        if departed is not None:
            self.batch.deactivate(departed)
        if arrived is not None:
            self.batch.activate(arrived)
        if not isinstance(envs, EnvArrays):
            envs = EnvArrays.from_envs(envs)
        if envs.k != self.batch.capacity:
            raise ValueError(
                f"envs must carry {self.batch.capacity} rows, got {envs.k}"
            )
        self._staged = envs

    def _tick(self) -> SessionTickReport | None:
        """Run the staged tick (broker-internal).  Atomic: on failure the
        batch state is untouched and the staged envs are kept, so the
        next broker tick retries the whole observation."""
        if self._staged is None:
            return None
        t = self.broker.tenant(self.tenant)
        report = tick_sessions(
            self.batch,
            self._staged,
            profile=t.profile,
            model=t.cost_model,
            cache=t.cache,
            backend=self.broker.backend,
            buckets=self.broker.buckets,
            device=self.broker.device,
            device_telemetry=self.device_telemetry,
            faults=self.broker.fault_injector,
            resilience=self.broker.resilience,
            tick=self.broker._tick,
            sleep=self.broker._backoff_sleep,
            tracer=self.broker.tracer,
            metrics=self.broker.metrics,
        )
        self._staged = None
        self._reports.append(report)
        return report

    def discard_staged(self) -> None:
        """Drop a staged-but-unticked observation (broker shutdown path:
        :meth:`~repro_torch.service.broker.OffloadBroker.drain`)."""
        self._staged = None

    def drain(self) -> list[SessionTickReport]:
        """Return (and clear) the reports of every completed tick."""
        reports = list(self._reports)
        self._reports.clear()
        return reports

    @property
    def pending(self) -> int:
        """Staged-but-unticked observations (0 or 1)."""
        return int(self._staged is not None)

    @property
    def active_sessions(self) -> int:
        return self.batch.active_count
