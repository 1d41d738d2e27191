"""The stdlib/numpy modules the port carries over behave like ``repro``'s.

``obs`` (metrics, trace) and ``service`` (scheduler, faults, resilience)
import neither JAX nor torch; the port keeps its own copies so that it
never imports ``repro``.  Same seeded inputs through both copies, ``==``.
"""

import dataclasses
import itertools

import numpy as np
import pytest

import repro.core as J
import repro.obs as JO
import repro.service as JS
import repro_torch.core as T
import repro_torch.obs as TO
import repro_torch.service as TS

pytestmark = pytest.mark.service


@pytest.mark.parametrize("seed", [0, 3])
def test_fault_injector_is_the_same_pure_function(seed):
    kw = dict(rate=0.3, rates={"solve": 0.6}, latency_s=0.004)
    fj, ft = JS.FaultInjector(seed, **kw), TS.FaultInjector(seed, **kw)
    assert JS.FAULT_SITES == TS.FAULT_SITES and JS.FAULT_KINDS == TS.FAULT_KINDS
    decisions = 0
    for site in TS.FAULT_SITES:
        for tick in range(6):
            for index in range(4):
                a, b = fj.decide(site, tick, index), ft.decide(site, tick, index)
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
                decisions += b.fires
    assert decisions > 10


def test_scheduler_drains_in_the_same_order():
    rng = np.random.default_rng(5)
    sj = JS.WeightedFairScheduler(max_queued_bins=12)
    st = TS.WeightedFairScheduler(max_queued_bins=12)
    for s in (sj, st):
        s.ensure_tenant("a", weight=3.0)
        s.ensure_tenant("b", weight=1.0)
        s.ensure_tenant("c", weight=0.5)
    accepted = []
    for i in range(60):
        tenant = "abc"[int(rng.integers(3))]
        lane = "elastic" if rng.random() < 0.1 else "user"
        bin_key = int(rng.integers(8))
        a = sj.submit(JS.QueueEntry(tenant, i, bin_key, lane))
        b = st.submit(TS.QueueEntry(tenant, i, bin_key, lane))
        assert a == b
        accepted.append(a)
    assert not all(accepted) and any(accepted)  # backpressure engaged
    while st.pending:
        dj = [(e.tenant, e.item, e.lane) for e in sj.drain(budget=7)]
        dt = [(e.tenant, e.item, e.lane) for e in st.drain(budget=7)]
        assert dj == dt
        assert sj.deficits() == st.deficits()
    assert sj.pending == 0


def test_circuit_breaker_walks_the_renamed_chain():
    """Same state machine; the chain's names are the port's."""
    bj = JS.CircuitBreaker(threshold=2, cooldown_ticks=3)
    bt = TS.CircuitBreaker(threshold=2, cooldown_ticks=3)
    rename = dict(zip(JS.BACKEND_ESCALATION, TS.BACKEND_ESCALATION))
    assert rename == {"pallas": "cuda", "jax": "torch", "reference": "reference"}
    script = [("f", "pallas", 0), ("f", "pallas", 0), ("b", "pallas", 1),
              ("f", "jax", 1), ("f", "jax", 1), ("b", "pallas", 2),
              ("b", "pallas", 4), ("s", "pallas", 4), ("b", "jax", 3)]
    for op, backend, tick in script:
        if op == "f":
            assert bj.record_failure(backend, tick) == bt.record_failure(rename[backend], tick)
        elif op == "s":
            bj.record_success(backend)
            bt.record_success(rename[backend])
        else:
            assert rename[bj.backend(backend, tick)] == bt.backend(rename[backend], tick)
    assert bj.trips == bt.trips == 2
    # for a solve on a GPU the port never swaps the backend, open or not
    assert bt.is_open("cuda", 2) and bt.backend("cuda", 2, escalate=False) == "cuda"
    rj, rt = JS.RetryPolicy(max_retries=3), TS.RetryPolicy(max_retries=3)
    assert [rj.backoff(a) for a in range(5)] == [rt.backoff(a) for a in range(5)]


def test_metrics_registry_snapshots_equal():
    rng = np.random.default_rng(2)
    values = rng.lognormal(-6, 1.5, 500)
    snaps = []
    for mod in (JO, TO):
        clock = itertools.count()
        reg = mod.MetricsRegistry(clock=lambda c=clock: float(next(c)))
        reg.counter("solves", backend="x", bucket=16).inc(3)
        reg.gauge("depth").set(7)
        reg.histogram("lat").observe_many(values)
        with reg.timer("tick_s", tenant="a"):
            pass
        snaps.append(reg.snapshot())
        h = reg.histogram("lat")
        snaps.append((h.p50, h.p90, h.p99, h.mean))
    assert snaps[0] == snaps[2] and snaps[1] == snaps[3]
    merged = TO.MetricsRegistry.from_snapshot(snaps[0])
    merged.merge(TO.MetricsRegistry.from_snapshot(snaps[2]))
    assert merged.get_counter("solves", backend="x", bucket=16).value == 6


def test_tracer_exports_equal(tmp_path):
    outs = []
    for name, mod in (("j", JO), ("t", TO)):
        clock = itertools.count()
        tr = mod.Tracer(clock=lambda c=clock: float(next(c)), capacity=8)
        with tr.span("tick", n=1) as root:
            with tr.span("stage.solve", batch=4) as sp:
                sp.set(devices=1)
                tr.event("retry", attempt=1)
            root.event("done")
        path = tmp_path / f"{name}.jsonl"
        assert tr.export_jsonl(path) == 2
        chrome = tmp_path / f"{name}.json"
        tr.export_chrome(chrome)
        outs.append((path.read_text(), chrome.read_text(),
                     [s.to_dict() for s in tr.spans("stage.solve")]))
    assert outs[0] == outs[1]


def test_instrumented_broker_emits_the_same_spans_and_metrics():
    """A reference-backend broker tick under a tracer and a registry: span
    names, attributes and counters equal repro's (``devices`` is 1 in
    both on one CPU device)."""
    def run(S, C, O):
        clock = itertools.count()
        tracer = O.Tracer(clock=lambda: float(next(clock)))
        reg = O.MetricsRegistry(clock=lambda: 0.0)
        broker = S.OffloadBroker(backend="reference", clock=lambda: 0.0,
                                 tracer=tracer, metrics=reg)
        profile = C.AppProfile.from_wcg_times(C.paper_example_graph())
        broker.register("app", profile, C.ResponseTimeModel())
        S.run_workload(broker, "app", n_users=4, steps=3, seed=1)
        group = broker.register_batch("app", 5)
        S.run_batch_workload(broker, group, steps=2, seed=2, initial=4)
        spans = [(s.name, sorted(s.attrs.items())) for s in tracer.spans()]
        return spans, reg.snapshot()["counters"]

    sj, cj = run(JS, J, JO)
    st, ct = run(TS, T, TO)
    assert sj == st
    assert cj == ct
