"""The slice as a whole: a broker workload through both packages.

One seeded batched-session workload and one per-object workload run
through ``repro.service.OffloadBroker`` and
``repro_torch.service.OffloadBroker``.  On the reference backend (numpy
f64 in both) events, tick reports and cache counters are ``==``.  On the
f32 backends (port ``"torch"``/``"cuda"`` on the CPU vs repro ``"jax"``)
placements and decisions are equal and prices, which are host f64 in
both, are ``==`` wherever the placements are.
"""

import dataclasses
import itertools

import numpy as np
import pytest

import repro.core as J
import repro.service as JS
import repro_torch.core as T
import repro_torch.service as TS
from repro_torch import convert

from _torch_parity import event_key, placement_key, profile_pair

pytestmark = pytest.mark.service

REPORT_FIELDS = (
    "steps", "active", "repartitioned", "cache_hit", "placements", "min_cut",
    "partial_cost", "no_offload_cost", "full_offload_cost", "gain",
)


def _face():
    pj = J.AppProfile.from_wcg_times(J.face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0))
    return pj, profile_pair(pj)


def _fake_clock():
    c = itertools.count()
    return lambda: float(next(c))


def _batch_run(S, C, profile, model, backend, **kw):
    broker = S.OffloadBroker(backend=backend, clock=_fake_clock(), **kw)
    broker.register("app", profile, model)
    group = broker.register_batch("app", 60, threshold=0.15, min_interval=2)
    reports = S.run_batch_workload(
        broker, group, steps=6, seed=7, arrival_rate=3.0, churn=0.05, initial=40
    )
    return broker, reports


def _object_run(S, profile, model, backend, **kw):
    broker = S.OffloadBroker(backend=backend, clock=_fake_clock(), **kw)
    broker.register("app", profile, model)
    work = S.run_workload(
        broker, "app", n_users=8, steps=7, threshold=0.15, min_interval=2, seed=3
    )
    return broker, work


def _tick_reports(broker):
    return [dataclasses.astuple(r) for r in broker.telemetry.reports]


def test_traffic_and_traces_are_the_same_inputs():
    gj = JS.TrafficGenerator(50, seed=7, arrival_rate=2.0, churn=0.05, initial=30)
    gt = TS.TrafficGenerator(50, seed=7, arrival_rate=2.0, churn=0.05, initial=30)
    for _ in range(4):
        a, b = gj.step(), gt.step()
        for f in ("active", "arrived", "departed"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(a.envs, b.envs):
            assert np.array_equal(x, y)
    tj, tt = JS.user_traces(3, 5, seed=2), TS.user_traces(3, 5, seed=2)
    assert [[dataclasses.astuple(e) for e in u] for u in tj] == [
        [dataclasses.astuple(e) for e in u] for u in tt
    ]


def test_batch_workload_reference_backend_is_bitwise_repro():
    pj, pt = _face()
    bj, rj = _batch_run(JS, J, pj, J.ResponseTimeModel(), "reference")
    bt, rt = _batch_run(TS, T, pt, T.ResponseTimeModel(), "reference")
    assert len(rj) == len(rt) == 6
    for a, b in zip(rj, rt):
        for f in REPORT_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f
        assert (a.hits, a.solved, a.coalesced, a.due) == (b.hits, b.solved, b.coalesced, b.due)
        assert [event_key(e) for e in a.events()] == [event_key(e) for e in b.events()]
    assert _tick_reports(bj) == _tick_reports(bt)
    sj, st = bj.tenant("app").cache.stats, bt.tenant("app").cache.stats
    assert (sj.hits, sj.misses, sj.evictions) == (st.hits, st.misses, st.evictions)
    assert bj.snapshot("app") == bt.snapshot("app")


def test_object_workload_reference_backend_is_bitwise_repro():
    pj, pt = _face()
    bj, wj = _object_run(JS, pj, J.WeightedModel(0.4), "reference")
    bt, wt = _object_run(TS, pt, T.WeightedModel(0.4), "reference")
    assert [[event_key(e) for e in u] for u in wj.events] == [
        [event_key(e) for e in u] for u in wt.events
    ]
    assert wt.n_repartitions == wj.n_repartitions > 8
    assert _tick_reports(bj) == _tick_reports(bt)
    sj, st = bj.tenant("app").cache.stats, bt.tenant("app").cache.stats
    assert (sj.hits, sj.misses) == (st.hits, st.misses)
    tel_j, tel_t = bj.telemetry.summary(), bt.telemetry.summary()
    assert tel_j == tel_t


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batch_workload_device_backends_give_repro_placements(backend):
    pj, pt = _face()
    bj, rj = _batch_run(JS, J, pj, J.ResponseTimeModel(), "jax", mesh=False)
    bt, rt = _batch_run(TS, T, pt, T.ResponseTimeModel(), backend, device="cpu")
    for a, b in zip(rj, rt):
        for f in ("steps", "active", "repartitioned", "cache_hit", "placements"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        # prices are host f64 on both sides: equal placements, equal prices
        for f in ("partial_cost", "no_offload_cost", "full_offload_cost", "gain"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        # installed cuts: solver's own f32 value on representatives
        np.testing.assert_allclose(a.min_cut, b.min_cut, rtol=1e-5, equal_nan=True)
        assert (a.hits, a.solved, a.coalesced) == (b.hits, b.solved, b.coalesced)
    assert bj.telemetry.batch_solved == bt.telemetry.batch_solved > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_object_workload_device_backends_give_repro_placements(backend):
    pj, pt = _face()
    bj, wj = _object_run(JS, pj, J.EnergyModel(), "jax", mesh=False)
    bt, wt = _object_run(TS, pt, T.EnergyModel(), backend, device="cpu")
    assert [[placement_key(e) for e in u] for u in wj.events] == [
        [placement_key(e) for e in u] for u in wt.events
    ]
    assert [[e.partial_cost for e in u] for u in wj.events] == [
        [e.partial_cost for e in u] for u in wt.events
    ]
    assert bj.telemetry.dispatches == bt.telemetry.dispatches > 0


def test_fused_tick_and_device_telemetry_on_cpu():
    pj, pt = _face()
    gen = TS.TrafficGenerator(40, seed=5, arrival_rate=2.0, churn=0.05, initial=30)
    tick = gen.step()
    out = {}
    for backend in ("reference", "cuda_fused"):
        batch = T.SessionBatch.create(40, pt.n, threshold=0.15, min_interval=2)
        batch.activate(tick.arrived)
        out[backend] = T.tick_sessions(
            batch, tick.envs, profile=pt, model=T.ResponseTimeModel(),
            cache=T.PlacementCache(), backend=backend, device="cpu",
            device_telemetry=True,
        )
    ref, fused = out["reference"], out["cuda_fused"]
    assert np.array_equal(ref.placements, fused.placements)
    assert np.array_equal(ref.partial_cost, fused.partial_cost)
    assert fused.device_summary["partial_mean"] == pytest.approx(
        float(fused.partial_cost[fused.active].mean()), rel=1e-5
    )
    # repro's fused tick on the same traffic
    jb = J.SessionBatch.create(40, pj.n, threshold=0.15, min_interval=2)
    jb.activate(tick.arrived)
    jrep = J.tick_sessions(
        jb, J.EnvArrays(*tick.envs), profile=pj, model=J.ResponseTimeModel(),
        cache=J.PlacementCache(), backend="pallas_fused", mesh=False,
    )
    assert np.array_equal(jrep.placements, fused.placements)


def test_session_state_crosses_packages():
    """A checkpoint taken in repro continues in the port, bit for bit."""
    pj, pt = _face()
    gj = JS.TrafficGenerator(30, seed=9, arrival_rate=2.0, churn=0.1, initial=20)
    ticks = [gj.step() for _ in range(4)]
    jb = J.SessionBatch.create(30, pj.n, threshold=0.15, min_interval=2)
    cache_j = J.PlacementCache()

    def advance(mod, batch, cache, profile, model, tk):
        batch.deactivate(tk.departed)
        batch.activate(tk.arrived)
        envs = tk.envs if mod is J else convert.env_arrays_from_columns(tk.envs._asdict())
        return mod.tick_sessions(batch, envs, profile=profile, model=model,
                                 cache=cache, backend="reference")

    for tk in ticks[:2]:
        advance(J, jb, cache_j, pj, J.ResponseTimeModel(), tk)
    tb = convert.session_batch_from_state(
        jb.n, jb.threshold, jb.min_interval, [np.asarray(a) for a in jb.checkpoint()]
    )
    cache_t = convert.placement_cache_from_snapshot(cache_j.snapshot())
    for tk in ticks[2:]:
        rj = advance(J, jb, cache_j, pj, J.ResponseTimeModel(), tk)
        rt = advance(T, tb, cache_t, pt, T.ResponseTimeModel(), tk)
        for f in REPORT_FIELDS:
            assert np.array_equal(getattr(rj, f), getattr(rt, f), equal_nan=True), f
    moved = tb.to("cpu")
    assert moved.placements.dtype.is_floating_point is False
    assert np.array_equal(moved.steps.numpy(), tb.steps)


def test_failed_solve_restores_state(monkeypatch):
    from repro_torch.core import session_batch as sb

    _, pt = _face()
    batch = T.SessionBatch.create(4, pt.n)
    batch.activate(np.arange(4))
    envs = T.EnvArrays.from_envs([T.Environment.symmetric(2.0, 3.0)] * 4)
    before = batch.checkpoint()

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(sb, "solve_envs", boom)
    cache = T.PlacementCache()
    with pytest.raises(RuntimeError, match="device lost"):
        T.tick_sessions(batch, envs, profile=pt, model=T.ResponseTimeModel(),
                        cache=cache, backend="torch", device="cpu")
    for a, b in zip(before, batch.checkpoint()):
        assert np.array_equal(a, b, equal_nan=True)
    assert cache.stats.lookups == 0 and len(cache) == 0


def _resilient_broker(device):
    _, pt = _face()
    policy = TS.ResiliencePolicy(
        retry=TS.RetryPolicy(max_retries=2, base_backoff_s=0.0),
        breaker=TS.CircuitBreaker(threshold=1, cooldown_ticks=5),
    )
    broker = TS.OffloadBroker(
        backend="cuda", device=device, resilience=policy, clock=TS.InjectedClock()
    )
    broker.register("app", pt, T.ResponseTimeModel())
    return broker, pt


def test_resilient_broker_escalates_down_the_port_chain(monkeypatch):
    """Under a ResiliencePolicy a failing backend escalates cuda → torch →
    reference for solves on the CPU only.  Off the CPU the backend never
    changes: the dispatch retries as asked, then serves the §4.3 fallback."""
    from repro_torch.service import broker as broker_mod

    env = T.Environment.symmetric(2.0, 3.0)
    real = broker_mod.mcop_batch
    asked = []

    def flaky(batch, *, backend, **kw):
        asked.append(backend)
        if backend != "reference":
            raise RuntimeError("transient solver failure")
        return real(batch, backend=backend, **kw)

    monkeypatch.setattr(broker_mod, "mcop_batch", flaky)
    broker, pt = _resilient_broker("cpu")
    session = TS.BrokerSession(broker, "app")
    session.observe(env)
    report = broker.tick()
    (event,) = session.drain()
    assert asked == ["cuda", "torch", "reference"]
    assert report.breaker_trips == 2 and report.retries == 2 and report.degraded == 0
    ref = T.mcop_reference(T.ResponseTimeModel().build(pt, env))
    assert np.array_equal(event.result.local_mask, ref.local_mask)

    # the "meta" device holds no data, so every solve on it fails on any
    # machine; it stands for a device other than the CPU
    asked.clear()
    broker, pt = _resilient_broker("meta")
    session = TS.BrokerSession(broker, "app")
    session.observe(env)
    report = broker.tick()
    (event,) = session.drain()
    assert asked == ["cuda", "cuda", "cuda"]
    assert report.retries == 2 and report.degraded == 1
    assert event.result.local_mask.all()  # the all-local fallback plan


@pytest.mark.parametrize("path", ["object", "batched", "tick_sessions"])
def test_kernel_error_is_never_contained(monkeypatch, path):
    """A kernel that cannot run (no device, failed build, refused launch)
    propagates through every retry, breaker and degradation layer."""
    from repro_torch.core import session_batch as sb
    from repro_torch.kernels.build import KernelError
    from repro_torch.service import broker as broker_mod

    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise KernelError("nvcc failed for mcop_sw.cu")

    monkeypatch.setattr(broker_mod, "mcop_batch", broken)
    monkeypatch.setattr(sb, "solve_envs", broken)
    broker, pt = _resilient_broker("cpu")
    env = T.Environment.symmetric(2.0, 3.0)
    if path == "object":
        TS.BrokerSession(broker, "app").observe(env)
        run = broker.tick
    elif path == "batched":
        group = broker.register_batch("app", 4)
        group.observe(T.EnvArrays.from_envs([env] * 4), arrived=np.arange(4))
        run = broker.tick
    else:
        batch = T.SessionBatch.create(4, pt.n)
        batch.activate(np.arange(4))

        def run():
            T.tick_sessions(
                batch, T.EnvArrays.from_envs([env] * 4), profile=pt,
                model=T.ResponseTimeModel(), cache=T.PlacementCache(),
                backend="cuda", device="cpu", resilience=broker.resilience)

    with pytest.raises(KernelError, match="nvcc failed"):
        run()
    assert len(calls) == 1  # not retried
    assert broker.resilience.breaker.trips == 0  # not counted


def test_kernel_failures_raise_kernel_error(monkeypatch, tmp_path):
    """Build and launch failures have their own type: no compiler, a
    missing source, a library that does not load, a refused launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mcop_phase as K

    assert issubclass(build.KernelError, RuntimeError)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(build.KernelError, match="nvcc not found"):
        build.nvcc_path()
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    with pytest.raises(build.KernelError, match="source missing"):
        build._start("no_such_kernel")
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not a library")
    monkeypatch.setattr(build, "_lib_path", lambda name: bad)
    with pytest.raises(build.KernelError, match="cannot load"):
        build.load("mcop_sw")
    with pytest.raises(build.KernelError, match="planning"):
        K._plan(lambda n, batch, graphs_per_block, out: 1, 16, 1)
    assert build._LIBS == {}
