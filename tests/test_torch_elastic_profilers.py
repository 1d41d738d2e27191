"""``repro_torch.runtime.elastic`` and ``repro_torch.profilers.{network,
energy}`` against the JAX package's modules of the same names, on the
same inputs.

Everything here is host numpy f64 in both packages (the elastic manager
solves with the f64 reference MCOP by default), so the contract is ``==``:
failures, stragglers, reassignments, plans, events, bandwidth estimates,
variances and energies.  The one f32 solve, ``submit_resize`` through a
port broker on the ``"torch"`` backend, is held to the synchronous
reference resize by its placement (``stage_tier`` and cut bytes ``==``)
and its cut to ``rtol=1e-5``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.configs import ARCHITECTURES as J_ARCHS, SHAPES as J_SHAPES
from repro.core.placement import TPUV5E_TIER as J_TIER
from repro.profilers import EnergyProfiler as JEnergy
from repro.profilers import NetworkProfiler as JNetwork
from repro.profilers import SimulatedChannel as JChannel
from repro.profilers.program import stage_specs as j_stage_specs
from repro.runtime import ElasticMeshManager as JManager
from repro.runtime import HeartbeatMonitor as JMonitor
import repro_torch.core as T
from repro_torch.configs import ARCHITECTURES as T_ARCHS, SHAPES as T_SHAPES
from repro_torch.core.placement import TPUV5E_TIER as T_TIER
from repro_torch.profilers import EnergyProfiler, NetworkProfiler, SimulatedChannel
from repro_torch.profilers.program import stage_specs
from repro_torch.runtime import ElasticMeshManager, HeartbeatMonitor
from repro_torch.service import OffloadBroker

from _torch_parity import wcg_pair


def _tiers(tier, local_chips=128, remote_chips=128):
    return (dataclasses.replace(tier, name="local", chips=local_chips),
            dataclasses.replace(tier, name="remote", chips=remote_chips))


@pytest.fixture(scope="module")
def stages():
    """qwen2-7b's stage specs at train_4k, group 4, in both packages."""
    return (j_stage_specs(J_ARCHS["qwen2-7b"], J_SHAPES["train_4k"], group=4),
            stage_specs(T_ARCHS["qwen2-7b"], T_SHAPES["train_4k"], group=4))


def _plan_key(plan):
    return (plan.stage_tier.tolist(), plan.mcop_cost, plan.contiguous_boundary,
            plan.contiguous_cost, plan.contiguity_penalty, plan.cut_bytes,
            plan.result.local_mask.tolist())


def _event_key(ev):
    return (ev.step, ev.reason, dataclasses.astuple(ev.tier_local),
            dataclasses.astuple(ev.tier_remote), _plan_key(ev.plan))


# ---- heartbeat monitor -------------------------------------------------------


def _drive_monitor(cls):
    t = [0.0]
    mon = cls(range(4), deadline=10.0, clock=lambda: t[0])
    for d in range(4):
        mon.heartbeat(d, step_time=1.0)
    # device 3 goes silent; device 2 slows to 4x the median
    for _ in range(6):
        t[0] += 5.0
        for d in (0, 1):
            mon.heartbeat(d, step_time=1.0)
        mon.heartbeat(2, step_time=4.0)
    out = [mon.failed(), mon.stragglers(), mon.reassignment(9), mon.reassignment(10)]
    mon.mark_failed(0)
    out += [mon.failed(), mon.reassignment(7),
            {d: (st.alive, st.step_time_ewma, st.last_heartbeat)
             for d, st in mon.devices.items()}]
    return out


def test_heartbeat_failure_straggler_and_reassignment_equal_repro():
    got, want = _drive_monitor(HeartbeatMonitor), _drive_monitor(JMonitor)
    assert got == want
    assert got[0] == [3] and got[1] == [2]
    assert sum(got[2].values()) == 9 and got[2][3] == 0 and got[2][2] < got[2][0]


@pytest.mark.parametrize("cls", [HeartbeatMonitor, JMonitor])
def test_reassignment_with_every_device_lost_raises(cls):
    t = [0.0]
    mon = cls([0, 1], deadline=1.0, clock=lambda: t[0])
    mon.mark_failed(0)
    t[0] += 5.0  # device 1 misses its deadline
    with pytest.raises(RuntimeError):
        mon.reassignment(4)


# ---- elastic manager -----------------------------------------------------------


def test_resize_plans_and_events_equal_repro(stages):
    j_stages, t_stages = stages
    jm = JManager(j_stages, *_tiers(J_TIER))
    tm = ElasticMeshManager(t_stages, *_tiers(T_TIER))
    assert tm.backend == "reference" and tm.device == "cuda"  # plan_placement's defaults
    assert _plan_key(tm.plan) == _plan_key(jm.plan)
    assert tm.speedup == jm.speedup == pytest.approx(1.0)
    for step, kw, reason in ((100, {"remote_chips": 16}, "failure"),
                             (200, {"remote_chips": 512}, "scale_up"),
                             (300, {"local_chips": 32}, "straggler")):
        ev_t, ev_j = tm.resize(step, reason=reason, **kw), jm.resize(step, reason=reason, **kw)
        assert _event_key(ev_t) == _event_key(ev_j)
        assert tm.speedup == jm.speedup
    assert [_event_key(e) for e in tm.events] == [_event_key(e) for e in jm.events]
    # the remote pod losing 7/8 of its chips moves work local; growing moves it out
    assert tm.events[0].plan.stage_tier.sum() <= tm.events[1].plan.stage_tier.sum()


@pytest.mark.parametrize("pkg", ["repro_torch", "repro"])
def test_losing_every_chip_raises_and_keeps_the_tiers(stages, pkg):
    j_stages, t_stages = stages
    mgr = (ElasticMeshManager(t_stages, *_tiers(T_TIER)) if pkg == "repro_torch"
           else JManager(j_stages, *_tiers(J_TIER)))
    with pytest.raises(RuntimeError):
        mgr.resize(step=1, remote_chips=0)
    with pytest.raises(RuntimeError):
        mgr.resize(step=1, local_chips=0)
    assert (mgr.tier_local.chips, mgr.tier_remote.chips) == (128, 128)
    assert mgr.events == []


def test_submit_resize_through_a_port_broker_equals_sync_resize(stages):
    """The elastic lane of a port broker on the plain solver (``"torch"``
    on the CPU) against synchronous reference resizes; two overlapping
    resizes resolved out of order never roll the plan back."""
    _, t_stages = stages
    tl, tr = _tiers(T_TIER)
    sync = ElasticMeshManager(t_stages, tl, tr)
    mgr = ElasticMeshManager(t_stages, tl, tr)
    broker = OffloadBroker(backend="torch", device="cpu", clock=lambda: 0.0)
    broker.register("fleet")  # a raw-graph tenant
    pending = mgr.submit_resize(broker, "fleet", step=100, remote_chips=16, reason="failure")
    assert not pending.done
    with pytest.raises(RuntimeError):
        pending.resolve()  # no tick yet
    broker.tick()
    ev = pending.resolve()
    want = sync.resize(step=100, remote_chips=16, reason="failure")
    assert ev.plan.stage_tier.tolist() == want.plan.stage_tier.tolist()
    assert ev.plan.cut_bytes == want.plan.cut_bytes
    assert ev.plan.mcop_cost == pytest.approx(want.plan.mcop_cost, rel=1e-5)
    assert mgr.plan is ev.plan and len(mgr.events) == 1

    # out of order: the newer resize resolves first, the older one late
    p_old = mgr.submit_resize(broker, "fleet", step=1, remote_chips=32, reason="brownout")
    p_new = mgr.submit_resize(broker, "fleet", step=2, remote_chips=512, reason="scale_up")
    broker.tick()
    ev_new, ev_old = p_new.resolve(), p_old.resolve()
    assert (ev_old.tier_remote.chips, ev_new.tier_remote.chips) == (32, 512)
    assert mgr.plan is ev_new.plan  # the stale plan did not clobber the newer one
    for got, chips in ((ev_old, 32), (ev_new, 512)):
        want = ElasticMeshManager(t_stages, tl, tr).resize(step=0, remote_chips=chips)
        assert got.plan.stage_tier.tolist() == want.plan.stage_tier.tolist()
        assert got.plan.cut_bytes == want.plan.cut_bytes


# ---- network and energy profilers ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_network_profiler_estimates_equal_repro(seed):
    def drive(channel_cls, profiler_cls):
        ch = channel_cls(2e9, jitter=0.1, latency=2e-4, seed=seed)
        prof = profiler_cls(ch, alpha=0.25, probe_bytes=1 << 16)
        out = []
        for i in range(12):
            if i == 6:
                ch.set_bandwidth(5e8)  # the user moves: a regime shift
            out.append((prof.probe(), prof.std, prof.relative_uncertainty()))
        sample = ch.transfer(4096)
        prof.record(sample)
        out.append((sample.bytes_moved, sample.seconds, sample.bandwidth, prof.bandwidth,
                    len(prof.samples)))
        return out

    assert drive(SimulatedChannel, NetworkProfiler) == drive(JChannel, JNetwork)


def test_network_profiler_without_samples_or_channel_raises():
    for cls in (NetworkProfiler, JNetwork):
        prof = cls()
        with pytest.raises(RuntimeError):
            prof.bandwidth
        with pytest.raises(RuntimeError):
            prof.probe()
        assert prof.relative_uncertainty() == float("inf")


@pytest.mark.parametrize("seed", range(3))
def test_energy_profiler_measure_equals_repro(seed):
    rng = np.random.default_rng(seed)
    gj = J.random_wcg(9, rng=rng)
    mask = rng.random(9) < 0.5
    env_j = J.Environment(1.5, 0.7, 3.0, 0.9, 0.3, 1.3)
    env_t = T.Environment(1.5, 0.7, 3.0, 0.9, 0.3, 1.3)
    got = EnergyProfiler(env_t).measure(wcg_pair(gj), mask)
    want = JEnergy(env_j).measure(gj, mask)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.total_j == want.total_j
