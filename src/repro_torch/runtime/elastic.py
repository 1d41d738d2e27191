"""Elastic scaling & straggler mitigation — the paper's adaptive loop at
cluster scale.

The paper re-partitions when the *environment* drifts (bandwidth, cloud
speed).  On an accelerator fleet the same events are: chips lost or added
(changes tier compute capacity ⇒ the speedup factor F), and stragglers
(changes the *effective* tier speed).  Both are routed through the same
MCOP re-partitioning path via :class:`ElasticMeshManager`.

Nothing here touches real hardware: failures are *injected* (tests drive
``mark_failed``/``heartbeat`` with a fake clock), and the manager's output
is the thing a real deployment would act on — a new mesh shape, new tier
specs, and a fresh MCOP placement.

:meth:`ElasticMeshManager.resize` solves synchronously (through
``core.placement.plan_placement``, with the same ``backend`` and ``device``
defaults: the f64 reference on the host);
:meth:`ElasticMeshManager.submit_resize` instead enqueues the solve on a
:class:`repro_torch.service.broker.OffloadBroker`, where it coalesces with
per-user controller requests into the same per-bucket batched dispatch
(the broker's backend, device and solver fleet).  A port of the JAX
package's module of the same name; plans are ``==`` to its plans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cost_models import Environment
from repro_torch.core.placement import (
    PlacementPlan,
    StageSpec,
    TierSpec,
    _finalize_plan,
    build_stage_wcg,
    plan_placement,
)

__all__ = [
    "DeviceState",
    "HeartbeatMonitor",
    "ElasticMeshManager",
    "ElasticEvent",
    "PendingElasticEvent",
]


@dataclasses.dataclass
class DeviceState:
    device_id: int
    last_heartbeat: float
    step_time_ewma: float = 0.0  # seconds per step, EWMA
    alive: bool = True


class HeartbeatMonitor:
    """Deadline-based failure & straggler detection with an injectable clock.

    * a device missing ``deadline`` seconds of heartbeats is *failed*;
    * a device whose EWMA step time exceeds ``straggler_factor`` × the
      fleet median is a *straggler* — its microbatches are reassigned
      (returned by :meth:`reassignment`) rather than the whole step
      waiting on it.
    """

    def __init__(
        self,
        device_ids: Sequence[int],
        *,
        deadline: float = 30.0,
        straggler_factor: float = 2.0,
        ewma: float = 0.3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.clock = clock
        self.deadline = deadline
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        now = clock()
        self.devices = {d: DeviceState(d, last_heartbeat=now) for d in device_ids}

    # ------------------------------------------------------------------
    def heartbeat(self, device_id: int, step_time: float | None = None) -> None:
        st = self.devices[device_id]
        st.last_heartbeat = self.clock()
        st.alive = True
        if step_time is not None:
            st.step_time_ewma = (
                step_time
                if st.step_time_ewma == 0.0
                else (1 - self.ewma) * st.step_time_ewma + self.ewma * step_time
            )

    def mark_failed(self, device_id: int) -> None:
        self.devices[device_id].alive = False

    # ------------------------------------------------------------------
    def failed(self) -> list[int]:
        now = self.clock()
        out = []
        for d, st in self.devices.items():
            if not st.alive or (now - st.last_heartbeat) > self.deadline:
                st.alive = False
                out.append(d)
        return sorted(out)

    def stragglers(self) -> list[int]:
        alive = [st for st in self.devices.values() if st.alive and st.step_time_ewma > 0]
        if len(alive) < 2:
            return []
        median = float(np.median([st.step_time_ewma for st in alive]))
        return sorted(
            st.device_id
            for st in alive
            if st.step_time_ewma > self.straggler_factor * median
        )

    def reassignment(self, n_micro: int) -> dict[int, int]:
        """Microbatches per alive device, shifting load off stragglers.

        Straggler devices get half weight; failed devices get zero.  The
        returned dict maps device_id → microbatch count, summing to
        ``n_micro`` (deterministic largest-remainder rounding).
        """
        self.failed()  # refresh liveness
        slow = set(self.stragglers())
        weights = {
            d: (0.0 if not st.alive else (0.5 if d in slow else 1.0))
            for d, st in self.devices.items()
        }
        total = sum(weights.values())
        if total == 0:
            raise RuntimeError("no alive devices to assign microbatches to")
        raw = {d: n_micro * w / total for d, w in weights.items()}
        base = {d: int(np.floor(r)) for d, r in raw.items()}
        rem = n_micro - sum(base.values())
        order = sorted(raw, key=lambda d: raw[d] - base[d], reverse=True)
        for d in order[:rem]:
            base[d] += 1
        return base


@dataclasses.dataclass
class ElasticEvent:
    step: int
    reason: str                    # "failure" | "scale_up" | "straggler"
    tier_local: TierSpec
    tier_remote: TierSpec
    plan: PlacementPlan


class ElasticMeshManager:
    """Rebuilds tier specs on chip-count changes and re-runs MCOP.

    The paper's F = cloud_speed/device_speed becomes
    (chips_remote·peak)/(chips_local·peak); losing chips on either side
    changes F and therefore potentially the optimal cut — exactly the
    paper's "environment change ⇒ re-partition" loop (Fig. 1).
    """

    def __init__(
        self,
        stages: Sequence[StageSpec],
        tier_local: TierSpec,
        tier_remote: TierSpec,
        *,
        backend: str = "reference",
        device: str | torch.device = "cuda",
    ):
        self.stages = list(stages)
        self.tier_local = tier_local
        self.tier_remote = tier_remote
        self.backend = backend
        self.device = device
        self.events: list[ElasticEvent] = []
        # monotone resize serials: a pending (async) resolve must never
        # clobber self.plan with a plan older than the installed one
        self._resize_serial = 0
        self._plan_serial = 0
        self.plan = plan_placement(
            self.stages, tier_local, tier_remote, backend=backend, device=device
        )

    @property
    def speedup(self) -> float:
        return self.tier_remote.total_flops / self.tier_local.total_flops

    def _apply_chip_counts(
        self, local_chips: int | None, remote_chips: int | None
    ) -> None:
        """Shared tier mutation for resize()/submit_resize().  Validates
        BEFORE mutating so a rejected resize leaves the tiers intact."""
        new_local = self.tier_local.chips if local_chips is None else local_chips
        new_remote = self.tier_remote.chips if remote_chips is None else remote_chips
        if min(new_local, new_remote) <= 0:
            raise RuntimeError("a tier lost all its chips; cannot re-place")
        if local_chips is not None:
            self.tier_local = dataclasses.replace(self.tier_local, chips=local_chips)
        if remote_chips is not None:
            self.tier_remote = dataclasses.replace(self.tier_remote, chips=remote_chips)

    def resize(self, step: int, *, local_chips: int | None = None,
               remote_chips: int | None = None, reason: str = "failure") -> ElasticEvent:
        self._apply_chip_counts(local_chips, remote_chips)
        self._resize_serial += 1
        self._plan_serial = self._resize_serial
        self.plan = plan_placement(
            self.stages, self.tier_local, self.tier_remote, backend=self.backend,
            device=self.device,
        )
        ev = ElasticEvent(step, reason, self.tier_local, self.tier_remote, self.plan)
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------------
    def submit_resize(
        self,
        broker,
        tenant: str,
        step: int,
        *,
        local_chips: int | None = None,
        remote_chips: int | None = None,
        reason: str = "failure",
    ) -> "PendingElasticEvent":
        """Async :meth:`resize`: enqueue the MCOP solve on an OffloadBroker.

        Elastic events are just another client of the serving tier: the
        stage WCG is rebuilt under the new chip counts and submitted to
        the broker's queue, joining user solves in the same coalesced
        per-bucket dispatch at the next tick.  Recurring fleet states are
        cache hits — the bin key encodes everything the stage WCG is
        built from (link bandwidth, F, and the *absolute* per-tier
        throughputs, because compute times scale with total FLOPs while
        transfer times don't: two fleets with equal F but different
        sizes can have different optimal cuts).  The returned handle
        finalizes the plan — call :meth:`PendingElasticEvent.resolve`
        after ``broker.tick()``.  ``tenant`` must be registered on the
        broker (``profile=None`` raw-graph tenants are fine).
        """
        self._apply_chip_counts(local_chips, remote_chips)
        bw = min(self.tier_local.link_bw, self.tier_remote.link_bw)
        g = build_stage_wcg(self.stages, self.tier_local, self.tier_remote)
        # the quantizer bins all six Environment fields, so the power
        # slots carry the absolute tier scales into the key
        bin_env = Environment(
            bandwidth_up=bw,
            bandwidth_down=bw,
            speedup=self.speedup,
            p_compute=self.tier_local.total_flops,
            p_idle=self.tier_remote.total_flops,
            p_transfer=min(
                self.tier_local.total_hbm_bw, self.tier_remote.total_hbm_bw
            ),
        )
        # elastic events ride the broker's priority lane: a fleet resize
        # re-places before user refreshes drained in the same tick
        future = broker.submit_graph(tenant, g, bin_env, lane="elastic")
        self._resize_serial += 1
        return PendingElasticEvent(
            manager=self,
            step=step,
            reason=reason,
            future=future,
            graph=g,
            bw=bw,
            tier_local=self.tier_local,
            tier_remote=self.tier_remote,
            serial=self._resize_serial,
        )


@dataclasses.dataclass
class PendingElasticEvent:
    """A resize whose MCOP solve is in flight on the broker.

    Tier specs are *captured at submit time*: overlapping resizes may
    mutate the manager before this one resolves, and the recorded event
    must describe the fleet state its plan was actually solved on.
    """

    manager: ElasticMeshManager
    step: int
    reason: str
    future: object  # repro_torch.service.broker.PlacementFuture
    graph: object   # the stage WCG the solve was priced on
    bw: float
    tier_local: TierSpec
    tier_remote: TierSpec
    serial: int     # manager resize serial at submit time

    @property
    def done(self) -> bool:
        return self.future.done

    def resolve(self) -> ElasticEvent:
        """Finalize the plan from the broker reply and record the event.

        Raises if the broker has not ticked yet.  The reply is already
        clamped and priced on :attr:`graph`, so the resulting plan
        matches a synchronous :meth:`ElasticMeshManager.resize` under
        the same tier state.  ``manager.plan`` is only replaced when no
        newer resize has been installed meanwhile (out-of-order resolves
        never roll the fleet back to a stale plan).
        """
        reply = self.future.result
        mgr = self.manager
        plan = _finalize_plan(self.graph, reply.result, self.bw)
        if self.serial >= mgr._plan_serial:
            mgr.plan = plan
            mgr._plan_serial = self.serial
        ev = ElasticEvent(
            self.step, self.reason, self.tier_local, self.tier_remote, plan
        )
        mgr.events.append(ev)
        return ev
