"""Environment-adaptive repartitioning (paper Fig. 1) on the PyTorch port —
a day in the life.

    PYTHONPATH=src python examples/torch_adaptive_offload.py [--device cpu]

The counterpart of ``examples/adaptive_offload.py``, through
``repro_torch``.  A mobile device walks through changing network
conditions (WiFi → 3G → congested 3G → back), with the cloud occasionally
degraded; the AdaptiveController re-runs MCOP only when drift exceeds the
threshold, in one batched ``mcop_batch`` dispatch for all repartition
points, and a second user on the same streets turns their repartitions
into placement-cache hits.  Then the serving tier: an OffloadBroker
coalesces 12 users into one dispatch per bucket per tick, snapshots its
cache, and a restarted broker replays the same day with zero solver
dispatches.  Then chips failing out of a tier re-plan a model's stages
(ElasticMeshManager, synchronous and queued on the broker), and a
straggler is found and drained (HeartbeatMonitor).

The JAX example's ``backend="jax"`` is ``"torch"`` here on the CPU (plain
tensor code) and ``"cuda"`` on the GPU (the hand-written solve kernels).
Costs and gains are priced on the host in float64 and placements follow
the float32 parity contract, so on the CPU the output is the JAX
example's, line for line.  ``--device`` defaults to the GPU; without one
the run raises ``KernelError``.
"""

import argparse
import dataclasses
import sys
import tempfile

import numpy as np

from repro_torch.configs import ARCHITECTURES, SHAPES
from repro_torch.core import (
    AdaptiveController,
    AppProfile,
    Environment,
    PlacementCache,
    ResponseTimeModel,
    face_recognition_graph,
)
from repro_torch.core.placement import TPUV5E_TIER
from repro_torch.kernels.mcop_phase import require_device
from repro_torch.profilers.program import stage_specs
from repro_torch.runtime import ElasticMeshManager, HeartbeatMonitor
from repro_torch.service import OffloadBroker, run_workload, user_traces


def solve_backend(device) -> str:
    """The JAX example's ``"jax"`` backend on ``device``."""
    return "torch" if device.type == "cpu" else "cuda"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    backend = solve_backend(device)

    # ---- the paper's mobile scenario ---------------------------------
    print("=== Mobile walk: bandwidth trace (MB/s), F trace =============")
    prof = AppProfile.from_wcg_times(
        face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0)
    )
    cache = PlacementCache()   # shared across every user of this app profile
    ctl = AdaptiveController(prof, ResponseTimeModel(), threshold=0.15,
                             min_interval=2, backend=backend, device=device,
                             cache=cache)
    trace = [
        (8.0, 3.0, "office WiFi"),
        (7.6, 3.0, "WiFi, light load"),
        (1.2, 3.0, "walk outside → 3G"),
        (1.1, 3.0, "3G"),
        (0.3, 3.0, "congested cell"),
        (0.3, 1.5, "cloud degraded too"),
        (6.0, 3.0, "home WiFi"),
    ]
    # one batched dispatch for the whole walk's repartition points
    events = ctl.sweep([Environment.symmetric(bw, f) for bw, f, _ in trace])
    print(f"{'env':<20s} {'B':>5s} {'F':>4s} {'repart':>7s} {'cache':>5s} "
          f"{'no-off':>8s} {'full':>8s} {'partial':>8s} {'gain':>6s}")
    for (bw, f, label), ev in zip(trace, events):
        print(f"{label:<20s} {bw:5.1f} {f:4.1f} {str(ev.repartitioned):>7s} "
              f"{'hit' if ev.cache_hit else '-':>5s} "
              f"{ev.no_offload_cost:8.1f} {ev.full_offload_cost:8.1f} "
              f"{ev.partial_cost:8.1f} {ev.gain:6.1%}")
    n_repart = sum(e.repartitioned for e in ctl.history)
    print(f"→ {n_repart}/{len(trace)} observations triggered repartitioning "
          f"(threshold+cooldown hysteresis)")

    # a second user on the same streets: repartitions become cache hits
    ctl2 = AdaptiveController(prof, ResponseTimeModel(), threshold=0.15,
                              min_interval=2, backend=backend, device=device,
                              cache=cache)
    events2 = ctl2.sweep([Environment.symmetric(bw, f) for bw, f, _ in trace])
    st = cache.stats
    print(f"→ user 2, same walk: {sum(e.cache_hit for e in events2)}"
          f"/{sum(e.repartitioned for e in events2)} repartitions served "
          f"from cache; totals hits={st.hits} misses={st.misses} "
          f"hit_rate={st.hit_rate:.0%}\n")

    # ---- the serving tier: many users, one broker ---------------------
    print("=== Offload broker: a fleet of users, one dispatch per bucket =")
    n_users, steps = 12, 10
    broker = OffloadBroker(backend=backend, device=device)
    broker.register("face", prof, ResponseTimeModel())
    traces = user_traces(n_users, steps, seed=42)
    run_workload(broker, "face", n_users=n_users, steps=steps, traces=traces)
    tel = broker.telemetry
    print(f"{n_users} users x {steps} ticks: {tel.requests} solve requests "
          f"→ {tel.solved} solves in {tel.dispatches} dispatches "
          f"(coalesce={tel.coalesce_ratio:.0%}, cache hit={tel.hit_rate:.0%}, "
          f"max queue={tel.max_queue_depth})")

    # serving restart: snapshot the cache, warm-start a new broker, replay
    with tempfile.TemporaryDirectory() as tmp:
        snap_path = f"{tmp}/face_cache.json"
        broker.save_snapshot("face", snap_path)
        broker2 = OffloadBroker(backend=backend, device=device)
        broker2.register("face", prof, ResponseTimeModel(), warm_start=snap_path)
        run_workload(broker2, "face", n_users=n_users, steps=steps, traces=traces)
    t2 = broker2.telemetry
    print(f"→ restart + warm cache, same day replayed: {t2.dispatches} solver "
          f"dispatches, hit rate {t2.hit_rate:.0%}\n")

    # ---- the cluster-scale analogue -----------------------------------
    print("=== Elastic fleet: chip loss re-prices the speedup factor ====")
    cfg = ARCHITECTURES["qwen2-7b"]
    stages = stage_specs(cfg, SHAPES["train_4k"], group=4)
    mgr = ElasticMeshManager(
        stages,
        dataclasses.replace(TPUV5E_TIER, name="pod-0", chips=128),
        dataclasses.replace(TPUV5E_TIER, name="pod-1", chips=128),
        device=device,
    )
    print(f"t=0   F={mgr.speedup:.2f} offloaded_stages="
          f"{int(mgr.plan.stage_tier.sum())}/{len(stages)}")
    ev = mgr.resize(step=120, remote_chips=32, reason="pod-1 ICI brownout")
    print(f"t=120 F={mgr.speedup:.2f} offloaded_stages="
          f"{int(ev.plan.stage_tier.sum())}/{len(stages)}  ({ev.reason})")
    ev = mgr.resize(step=300, remote_chips=256, reason="pod-1 restored+grown")
    print(f"t=300 F={mgr.speedup:.2f} offloaded_stages="
          f"{int(ev.plan.stage_tier.sum())}/{len(stages)}  ({ev.reason})")
    # elastic events are broker clients too: the solve queues with user
    # requests and lands at the next tick
    broker.register("fleet")
    pending = mgr.submit_resize(broker, "fleet", step=450, remote_chips=64,
                                reason="pod-1 partial brownout (queued)")
    broker.tick()
    ev = pending.resolve()
    print(f"t=450 F={mgr.speedup:.2f} offloaded_stages="
          f"{int(ev.plan.stage_tier.sum())}/{len(stages)}  ({ev.reason})\n")

    # ---- straggler mitigation -----------------------------------------
    print("=== Straggler detection & microbatch reassignment ============")
    clock = [0.0]
    mon = HeartbeatMonitor(range(8), deadline=30.0, straggler_factor=2.0,
                           clock=lambda: clock[0])
    rng = np.random.default_rng(0)
    for tick in range(10):
        clock[0] += 10.0
        for d in range(8):
            if d == 5 and tick > 4:
                continue                      # device 5 dies at t=50
            st = 1.0 + 0.05 * rng.standard_normal()
            if d == 2:
                st *= 3.0                     # device 2 is a straggler
            mon.heartbeat(d, step_time=st)
    print("failed:", mon.failed(), " stragglers:", mon.stragglers())
    assign = mon.reassignment(n_micro=32)
    print("microbatch assignment (32 total):", assign)
    print("→ dead device drained; straggler at half weight")
    return 0


if __name__ == "__main__":
    sys.exit(main())
