"""Deterministic simulated multi-user workload for the offload broker.

N users walk :class:`~repro_torch.profilers.network.SimulatedChannel`-style
environment traces: each regime has a true (bandwidth, speedup) pair and
observations carry small relative measurement noise, so users in the
same regime land in the same quantized cache bin while the trace still
exercises the drift detector.  Everything is seeded — traces replay
bit-identically, which is what makes the broker's warm-restart claim
testable (same trace + warm cache ⇒ zero solver dispatches) and keeps
the service tests in tier-1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.adaptive import AdaptationEvent
from repro_torch.core.cost_models import EnvArrays, Environment
from repro_torch.core.session_batch import SessionTickReport
from repro_torch.service.broker import OffloadBroker
from repro_torch.service.session import BatchSessionGroup, BrokerSession

__all__ = [
    "Regime",
    "DEFAULT_REGIMES",
    "environment_trace",
    "user_traces",
    "WorkloadReport",
    "run_workload",
    "TrafficTick",
    "TrafficGenerator",
    "run_batch_workload",
]


@dataclasses.dataclass(frozen=True)
class Regime:
    """One recurring mobile environment (paper §7 scenarios)."""

    name: str
    bandwidth: float  # MB/s, symmetric up/down
    speedup: float    # the paper's F


DEFAULT_REGIMES: tuple[Regime, ...] = (
    Regime("wifi", 8.0, 3.0),
    Regime("lte", 2.5, 3.0),
    Regime("3g", 1.2, 3.0),
    Regime("congested", 0.3, 3.0),
    Regime("cloud-degraded", 0.3, 1.5),
)


def environment_trace(
    steps: int,
    *,
    regimes: Sequence[Regime] = DEFAULT_REGIMES,
    seed: int = 0,
    dwell: tuple[int, int] = (2, 5),
    rel_noise: float = 0.02,
) -> list[Environment]:
    """One user's seeded walk: dwell in a regime, hop to a neighbor.

    ``rel_noise`` (2% default) is well inside the cache quantizer's 10%
    bins, so repeated visits to a regime hit the same bin — the recurring
    structure the broker exploits — while differing measurements still
    flow through the drift detector.
    """
    rng = np.random.default_rng(seed)
    trace: list[Environment] = []
    regime = int(rng.integers(len(regimes)))
    while len(trace) < steps:
        stay = int(rng.integers(dwell[0], dwell[1] + 1))
        r = regimes[regime]
        for _ in range(min(stay, steps - len(trace))):
            noise_b, noise_f = 1.0 + rel_noise * rng.standard_normal(2)
            trace.append(
                Environment.symmetric(r.bandwidth * noise_b, r.speedup * noise_f)
            )
        # hop to an adjacent regime (environments drift, they don't teleport)
        regime = int(
            np.clip(regime + rng.choice((-1, 1)), 0, len(regimes) - 1)
        )
    return trace


def user_traces(
    n_users: int,
    steps: int,
    *,
    seed: int = 0,
    regimes: Sequence[Regime] = DEFAULT_REGIMES,
    **kw,
) -> list[list[Environment]]:
    """Per-user traces; user u gets the seeded walk ``seed + u``."""
    return [
        environment_trace(steps, regimes=regimes, seed=seed + u, **kw)
        for u in range(n_users)
    ]


@dataclasses.dataclass
class WorkloadReport:
    """Everything a test or benchmark needs to audit one workload run."""

    events: list[list[AdaptationEvent]]   # [user][step]
    traces: list[list[Environment]]       # the envs that were replayed
    ticks: int

    @property
    def n_repartitions(self) -> int:
        return sum(e.repartitioned for evs in self.events for e in evs)

    @property
    def n_cache_hits(self) -> int:
        return sum(e.cache_hit for evs in self.events for e in evs)


def run_workload(
    broker: OffloadBroker,
    tenant: str,
    *,
    n_users: int,
    steps: int,
    threshold: float = 0.15,
    min_interval: int = 2,
    seed: int = 0,
    regimes: Sequence[Regime] = DEFAULT_REGIMES,
    traces: Sequence[Sequence[Environment]] | None = None,
) -> WorkloadReport:
    """Drive N users through the broker, one tick per timestep.

    Per tick every user observes its next environment (enqueuing solves
    for due repartitions), the broker flushes once, and sessions drain —
    the serving loop in miniature.  Pass ``traces`` to replay a known
    workload (e.g. against a warm-started broker); otherwise seeded
    traces are generated with :func:`user_traces`.
    """
    if traces is None:
        traces = user_traces(
            n_users, steps, seed=seed, regimes=regimes
        )
    else:
        traces = [list(t) for t in traces]
        if len(traces) != n_users or any(len(t) != steps for t in traces):
            raise ValueError("traces must be n_users × steps")
    sessions = [
        BrokerSession(
            broker, tenant, threshold=threshold, min_interval=min_interval
        )
        for _ in range(n_users)
    ]
    events: list[list[AdaptationEvent]] = [[] for _ in range(n_users)]
    for t in range(steps):
        for session, trace in zip(sessions, traces):
            session.observe(trace[t])
        broker.tick()
        for u, session in enumerate(sessions):
            events[u].extend(session.drain())
    assert all(s.pending == 0 for s in sessions)
    return WorkloadReport(events=events, traces=traces, ticks=steps)


# ----------------------------------------------------------------------
# Array-native traffic: Poisson arrivals + geometric churn over a fixed
# capacity of session slots, vectorized regime walks — the 10⁵–10⁶-user
# feed for BatchSessionGroup ticks.
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficTick:
    """One tick of generated traffic over all capacity slots.

    ``envs`` carries a row for every slot — inactive rows hold a
    harmless placeholder environment (bandwidth = speedup = 1) that the
    batched tick prices but never acts on (inactive sessions are never
    due).  ``arrived``/``departed`` are this tick's churn, already
    reflected in ``active``.
    """

    envs: EnvArrays
    active: np.ndarray    # (capacity,) bool — live after this tick's churn
    arrived: np.ndarray   # (capacity,) bool — slots activated this tick
    departed: np.ndarray  # (capacity,) bool — slots freed this tick


class TrafficGenerator:
    """Seeded vectorized traffic source for a fixed-capacity slot pool.

    Per :meth:`step`, in order: geometric churn (each live session
    departs with probability ``churn``), Poisson(``arrival_rate``)
    arrivals filling the lowest free slots (plus ``initial`` sessions on
    the first step), then one vectorized regime-walk update — ongoing
    sessions count down a dwell timer and hop to an adjacent regime when
    it expires, mirroring :func:`environment_trace`'s walk, and
    observations carry the same 2% relative measurement noise.

    Determinism: every random draw is a fixed-size (capacity,) array
    each step, so the generated traffic is a pure function of
    ``(seed, capacity, step)`` — independent of how occupancy evolves —
    and replays bit-identically (asserted by the churn determinism
    test).
    """

    def __init__(
        self,
        capacity: int,
        *,
        seed: int = 0,
        regimes: Sequence[Regime] = DEFAULT_REGIMES,
        arrival_rate: float = 1.0,
        churn: float = 0.05,
        initial: int | None = None,
        dwell: tuple[int, int] = (2, 5),
        rel_noise: float = 0.02,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if not (0.0 <= churn < 1.0):
            raise ValueError("churn must be in [0, 1)")
        self.capacity = int(capacity)
        self.regimes = tuple(regimes)
        self.arrival_rate = float(arrival_rate)
        self.churn = float(churn)
        self.initial = (
            min(int(initial), capacity) if initial is not None else capacity // 2
        )
        self.dwell = (int(dwell[0]), int(dwell[1]))
        self.rel_noise = float(rel_noise)
        self.rng = np.random.default_rng(seed)
        self._band = np.array([r.bandwidth for r in self.regimes])
        self._speed = np.array([r.speedup for r in self.regimes])
        self._active = np.zeros(self.capacity, dtype=bool)
        self._regime = np.zeros(self.capacity, dtype=np.int64)
        self._dwell_left = np.zeros(self.capacity, dtype=np.int64)
        self._step = 0

    def step(self) -> TrafficTick:
        cap, rng = self.capacity, self.rng
        n_regimes = len(self.regimes)

        # geometric churn: each live session departs with prob `churn`
        departed = self._active & (rng.random(cap) < self.churn)
        self._active &= ~departed

        # Poisson arrivals fill the lowest free slots (first step also
        # seeds `initial` sessions so the pool starts warm)
        n_arrivals = int(rng.poisson(self.arrival_rate))
        if self._step == 0:
            n_arrivals += self.initial
        free = np.nonzero(~self._active)[0]
        arrived = np.zeros(cap, dtype=bool)
        arrived[free[:n_arrivals]] = True

        # fixed-size draws keep the stream occupancy-independent
        arr_regime = rng.integers(n_regimes, size=cap)
        arr_dwell = rng.integers(self.dwell[0], self.dwell[1] + 1, size=cap)
        hop_dir = rng.choice((-1, 1), size=cap)
        hop_dwell = rng.integers(self.dwell[0], self.dwell[1] + 1, size=cap)
        noise = 1.0 + self.rel_noise * rng.standard_normal((cap, 2))

        self._regime = np.where(arrived, arr_regime, self._regime)
        self._dwell_left = np.where(arrived, arr_dwell, self._dwell_left)
        self._active |= arrived

        # ongoing sessions walk: dwell counts down, expiry hops ±1 regime
        ongoing = self._active & ~arrived
        self._dwell_left = np.where(
            ongoing, self._dwell_left - 1, self._dwell_left
        )
        hop = ongoing & (self._dwell_left <= 0)
        self._regime = np.where(
            hop,
            np.clip(self._regime + hop_dir, 0, n_regimes - 1),
            self._regime,
        )
        self._dwell_left = np.where(hop, hop_dwell, self._dwell_left)

        band = np.where(
            self._active, self._band[self._regime] * noise[:, 0], 1.0
        )
        speed = np.where(
            self._active, self._speed[self._regime] * noise[:, 1], 1.0
        )
        envs = EnvArrays(
            bandwidth_up=band,
            bandwidth_down=band.copy(),
            speedup=speed,
            p_compute=np.full(cap, 0.9),
            p_idle=np.full(cap, 0.3),
            p_transfer=np.full(cap, 1.3),
        )
        self._step += 1
        return TrafficTick(
            envs=envs,
            active=self._active.copy(),
            arrived=arrived,
            departed=departed,
        )


def run_batch_workload(
    broker: OffloadBroker,
    group: BatchSessionGroup,
    *,
    steps: int,
    seed: int = 0,
    regimes: Sequence[Regime] = DEFAULT_REGIMES,
    arrival_rate: float = 1.0,
    churn: float = 0.05,
    initial: int | None = None,
) -> list[SessionTickReport]:
    """Drive a batch session group through seeded churning traffic.

    The batched sibling of :func:`run_workload`: one
    :class:`TrafficGenerator` step stages the whole pool's observations
    (arrivals and departures included), one ``broker.tick()`` resolves
    them.  Returns the per-tick
    :class:`~repro_torch.core.session_batch.SessionTickReport` list.
    """
    gen = TrafficGenerator(
        group.batch.capacity,
        seed=seed,
        regimes=regimes,
        arrival_rate=arrival_rate,
        churn=churn,
        initial=initial,
    )
    for _ in range(steps):
        tick = gen.step()
        group.observe(tick.envs, arrived=tick.arrived, departed=tick.departed)
        broker.tick()
    return group.drain()
