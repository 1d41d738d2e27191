#!/usr/bin/env python
"""Export a deterministic chaos-storm trace of the PyTorch port.

    PYTHONPATH=src python tools/torch_chaos_trace.py --out trace.jsonl \
        [--chrome trace.json] [--rate 0.10] [--steps 12] [--users 16] [--device cpu]

The counterpart of ``tools/chaos_trace.py``, through ``repro_torch``: a
seeded multi-user request stream through a resilient ``OffloadBroker``
(retry budget 2, ``degrade="fallback"``, ``CircuitBreaker(3, 4)``,
``FaultInjector(seed, rate, 1e-4)``) with a :class:`Tracer` and a
:class:`MetricsRegistry` attached, then the span trace exported.  Broker
and tracer share one :class:`InjectedClock`, so every timestamp in the
artifact is a function of the fault schedule alone.

The JAX tool's ``backend="jax"`` is ``"torch"`` here on the CPU and
``"cuda"`` on the GPU (``--device``, default the GPU; without one the run
raises ``KernelError``).  On the CPU the JSONL equals the JAX tool's at the
same arguments, span for span, but for the attributes that name a backend
(``jax`` -> ``torch``, ``pallas`` -> ``cuda``).  On the GPU the breaker does
not change backend (a kernel failure propagates), so that trace differs;
``tools/tracequery.py --audit`` holds either: every degraded reply must be
attributable to a same-tick injected fault.

Exits 2 if the workload left a request unresolved, 3 if a run with
rate > 0 recorded no fault.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.core import AppProfile, ResponseTimeModel, face_recognition_graph
from repro_torch.kernels.mcop_phase import require_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.service import (
    CircuitBreaker,
    FaultInjector,
    InjectedClock,
    OffloadBroker,
    ResiliencePolicy,
    RetryPolicy,
    user_traces,
)


def run_storm(
    *,
    rate: float,
    steps: int,
    users: int,
    seed: int,
    retries: int = 2,
    capacity: int = 65536,
    device: str = "cuda",
) -> tuple[OffloadBroker, Tracer, MetricsRegistry, list]:
    """Drive the seeded fault-storm workload with observability attached."""
    dev = require_device(device)
    clock = InjectedClock()
    tracer = Tracer(clock=clock, capacity=capacity)
    metrics = MetricsRegistry(clock=clock)
    broker = OffloadBroker(
        backend="torch" if dev.type == "cpu" else "cuda",
        device=dev,
        clock=clock,
        resilience=ResiliencePolicy(
            retry=RetryPolicy(
                max_retries=retries, base_backoff_s=1e-4, max_backoff_s=1e-3
            ),
            degrade="fallback",
            breaker=CircuitBreaker(threshold=3, cooldown_ticks=4),
        ),
        fault_injector=FaultInjector(seed=seed, rate=rate, latency_s=1e-4),
        tracer=tracer,
        metrics=metrics,
    )
    profile = AppProfile.from_wcg_times(
        face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0)
    )
    broker.register("app", profile, ResponseTimeModel())
    traces = user_traces(users, steps, seed=31)
    futures = []
    for t in range(steps):
        for u in range(users):
            futures.append(broker.submit("app", traces[u][t]))
        broker.tick()
    guard = 0
    while broker.pending and guard < 4 * steps:
        broker.tick()
        guard += 1
    return broker, tracer, metrics, futures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, required=True,
                    help="JSONL span trace (tools/tracequery.py format)")
    ap.add_argument("--chrome", type=pathlib.Path, default=None,
                    help="also export Chrome trace_event JSON")
    ap.add_argument("--metrics-out", type=pathlib.Path, default=None,
                    help="also dump the metrics registry snapshot (JSON)")
    ap.add_argument("--rate", type=float, default=0.10)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--users", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--retries", type=int, default=2,
                    help="retry budget (0 makes degraded replies likely)")
    ap.add_argument("--device", default="cuda",
                    help="where the solves run (default the GPU)")
    args = ap.parse_args(argv)

    broker, tracer, metrics, futures = run_storm(
        rate=args.rate,
        steps=args.steps,
        users=args.users,
        seed=args.seed,
        retries=args.retries,
        device=args.device,
    )
    if broker.pending or not all(f.done for f in futures):
        print("error: chaos workload left unresolved requests",
              file=sys.stderr)
        return 2

    n_spans = tracer.export_jsonl(args.out)
    if args.chrome is not None:
        tracer.export_chrome(args.chrome)
    if args.metrics_out is not None:
        args.metrics_out.write_text(
            json.dumps(metrics.snapshot(), indent=2, default=str) + "\n"
        )

    tel = broker.telemetry
    degraded = sum(f.result.degraded for f in futures)
    p50, p90, p99 = tel.tick_latency_quantiles()
    print(
        f"{n_spans} spans -> {args.out}; requests={len(futures)}"
        f" faults={tel.faults} retries={tel.retries}"
        f" breaker_trips={tel.breaker_trips} degraded={degraded}"
        f" tick_p50={p50 * 1e3:.3f}ms p99={p99 * 1e3:.3f}ms"
    )
    if args.rate > 0 and tel.faults == 0:
        print("error: chaos run recorded no faults (injector not wired?)",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
