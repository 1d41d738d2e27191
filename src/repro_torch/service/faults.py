"""Deterministic fault injection for the serving tier.

A production broker fails in boring, recurring ways — a transient device
error on a solve dispatch, a cache node timing out, a pricing pass
hitting corrupted weights, a latency spike — and the resilience layer
(`repro_torch.service.resilience`, wired through
:class:`~repro_torch.service.broker.OffloadBroker`) must be testable against
*exactly reproducible* schedules of those failures.  Python's salted
``hash()`` and any RNG shared with the workload would make schedules
drift across processes or interleave with unrelated draws, so the
injector here is a **pure function of (seed, tick, site, index)**: the
decision for a given coordinate is computed from a keyed blake2b digest
and nothing else.  Two injectors built with the same seed agree on
every decision, in any process, in any call order — the property the
``-m property`` suite asserts.

Sites (where the broker/session tick consults the injector):

* ``"solve"``       — around each ``mcop_batch``/``solve_envs`` dispatch.
* ``"pricing"``     — around the vectorized pricing evaluations.
* ``"cache_load"``  — per cache probe during request classification.
* ``"cache_store"`` — per representative store at commit time.

Kinds of fault a firing decision carries:

* ``"error"``   — a transient exception (:class:`InjectedFault`) raised
  at the site, exercising retry/backoff and the circuit breaker.
* ``"corrupt"`` — NaN poisoning of a *copy* of the site's inputs
  (:func:`poison_batch` / :func:`poison_envs`), exercising the
  finite-weight validation in ``WCGBatch``/``solve_envs`` — corruption
  must be *detected and retried*, never silently solved.
* ``"latency"`` — a deterministic delay (``delay_s``) charged to the
  broker clock (injected clocks advance, real clocks sleep); results
  are unchanged, only tick latency telemetry moves.

With ``rate=0`` (or ``enabled=False``) every decision is a non-firing
no-op and the broker's event stream is bit-identical to a broker
without an injector — asserted by the parity tests in
``tests/test_faults.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = [
    "FAULT_SITES",
    "FAULT_KINDS",
    "InjectedFault",
    "FaultDecision",
    "FaultInjector",
    "ScriptedFaultInjector",
    "poison_batch",
    "poison_envs",
]

FAULT_SITES = ("solve", "pricing", "cache_load", "cache_store")
FAULT_KINDS = ("error", "corrupt", "latency")


class InjectedFault(RuntimeError):
    """A deliberately injected transient failure (retryable)."""

    def __init__(self, site: str, tick: int, index: int, kind: str = "error"):
        super().__init__(
            f"injected {kind} fault at site={site!r} tick={tick} index={index}"
        )
        self.site = site
        self.tick = tick
        self.index = index
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """One (site, tick, index) coordinate's verdict."""

    fires: bool
    kind: str | None
    site: str
    tick: int
    index: int
    delay_s: float = 0.0


class FaultInjector:
    """Seeded deterministic injector: ``decide`` is a pure function.

    Parameters:
      seed:      schedule identity; equal seeds ⇒ identical schedules
                 in every process (keyed hashing, no salted ``hash``).
      rate:      default per-coordinate fault probability in [0, 1].
      rates:     optional per-site overrides, e.g. ``{"solve": 0.1}``
                 (sites not listed fall back to ``rate``).
      kinds:     fault kinds drawn uniformly when a coordinate fires.
      latency_s: base delay of a ``"latency"`` fault; the actual delay
                 is ``latency_s × (0.5 + u)`` with ``u`` from the same
                 deterministic stream, so spikes vary but replay.
      enabled:   master switch — ``False`` makes every decision a
                 non-firing no-op (tests flip it to end a fault storm).
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        rate: float = 0.0,
        rates: dict[str, float] | None = None,
        kinds: tuple[str, ...] = FAULT_KINDS,
        latency_s: float = 0.002,
        enabled: bool = True,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        for site, r in (rates or {}).items():
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}")
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1]")
        bad = [k for k in kinds if k not in FAULT_KINDS]
        if bad or not kinds:
            raise ValueError(f"unknown fault kinds {bad!r}")
        self.seed = int(seed)
        self._rate = float(rate)
        self._rates = dict(rates or {})
        self.kinds = tuple(kinds)
        self.latency_s = float(latency_s)
        self.enabled = bool(enabled)

    # -- the deterministic stream ----------------------------------------
    def _u(self, site: str, tick: int, index: int, stream: str) -> float:
        """Uniform [0, 1) keyed on the full coordinate.

        Distinct ``stream`` labels (fire / kind / delay) and distinct
        sites draw from independent hash streams: changing any component
        of the key decorrelates the value — the independence property
        the ``-m property`` suite checks.
        """
        h = hashlib.blake2b(
            f"{self.seed}|{site}|{tick}|{index}|{stream}".encode(),
            digest_size=8,
        )
        return int.from_bytes(h.digest(), "big") / 2.0**64

    def rate_for(self, site: str) -> float:
        return self._rates.get(site, self._rate)

    def decide(self, site: str, tick: int, index: int = 0) -> FaultDecision:
        """The (site, tick, index) coordinate's deterministic verdict."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        rate = self.rate_for(site)
        if not self.enabled or rate <= 0.0:
            return FaultDecision(False, None, site, tick, index)
        if self._u(site, tick, index, "fire") >= rate:
            return FaultDecision(False, None, site, tick, index)
        kind = self.kinds[
            int(self._u(site, tick, index, "kind") * len(self.kinds))
            % len(self.kinds)
        ]
        delay = (
            self.latency_s * (0.5 + self._u(site, tick, index, "delay"))
            if kind == "latency"
            else 0.0
        )
        return FaultDecision(True, kind, site, tick, index, delay_s=delay)


class ScriptedFaultInjector(FaultInjector):
    """Exact-coordinate schedule for targeted chaos tests.

    ``schedule`` maps ``(site, tick, index) -> kind``; every other
    coordinate is a non-firing no-op.  Shares the master ``enabled``
    switch with the base class.
    """

    def __init__(
        self,
        schedule: dict[tuple[str, int, int], str],
        *,
        latency_s: float = 0.002,
        enabled: bool = True,
    ):
        super().__init__(0, rate=0.0, latency_s=latency_s, enabled=enabled)
        for (site, _tick, _index), kind in schedule.items():
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
        self.schedule = dict(schedule)

    def decide(self, site: str, tick: int, index: int = 0) -> FaultDecision:
        kind = self.schedule.get((site, tick, index))
        if not self.enabled or kind is None:
            return FaultDecision(False, None, site, tick, index)
        delay = self.latency_s if kind == "latency" else 0.0
        return FaultDecision(True, kind, site, tick, index, delay_s=delay)


# -- corruption helpers ---------------------------------------------------
def poison_batch(batch):
    """A COPY of ``batch`` with one NaN-poisoned weight (corruption fault).

    The original is untouched, so a retry after the corruption is
    detected (``WCGBatch.validate_finite`` →
    :class:`~repro_torch.core.graph.NonFiniteWeightError`) solves clean inputs.
    """
    w_local = np.array(batch.w_local, dtype=np.float64, copy=True)
    w_local[0, 0] = np.nan
    return dataclasses.replace(batch, w_local=w_local)


def poison_envs(envs):
    """A COPY of ``envs`` with row 0's uplink bandwidth NaN-poisoned.

    Caught by the environment validation at the mouth of
    ``CostModel.build_batch`` / ``solve_envs`` — the batch never reaches
    the solver.
    """
    bw = np.array(envs.bandwidth_up, dtype=np.float64, copy=True)
    bw[0] = np.nan
    return envs._replace(bandwidth_up=bw)
