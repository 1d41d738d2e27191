#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, needs one GPU

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``,
then runs four phases and prints one JSON object per line:

1. ``env``          — GPU name and power limit, torch / CUDA / nvcc versions,
                      build seconds.
2. ``kernel_checks``— each kernel against its plain PyTorch version on the
                      card at every shape bucket (masks equal or equal-cost,
                      cuts to ``rtol=1e-5, atol=1e-5·C_local``), the fused
                      kernel against the solve kernel fed with
                      ``batch_weights``, and samples against the f64 oracle.
3. ``solve_plane``  — ``solve_envs`` / ``mcop_batch`` at full size.
4. ``broker``       — a two-tenant ``OffloadBroker`` tick loop (100 000
                      batched sessions + 256 per-object sessions), one fused
                      ``tick_sessions``, and a replay of the same workload on
                      the f64 reference backend that every placement must
                      match.

Phases 3 and 4 are the main path: the kernels' launch counters are zeroed
before and read after, and a kernel that was not launched fails the run.
Then a ``kernel_work`` line counts the work of the timed shapes (absorb steps
and the on-chip row traffic they imply: computed from the inputs, not
measured), a ``{"kernels": [...]}`` line gives, per kernel, its launches on
the main path, its measured time, its plain version's measured time and its
roofline bound at the solve-plane shape; the GPU's name and power limit; and
last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
GPU nothing runs.

Switches for work on the kernels (environment variables, all off by default):
``SMOKE_PTXAS=1`` rebuilds with ``-Xptxas -v`` and prints registers and
spills; ``SMOKE_ONLY_CHECKS=1`` stops after phase 2; ``SMOKE_CHECK_MIN_N=236``
skips phase 2's shapes below that vertex count (what is left runs the
kernels' scratch-matrix variant only); ``SMOKE_PROFILE=1`` wraps
the timed broker ticks in ``torch.profiler`` and reports the GPU's busy share.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

RTOL = 1e-5          # cut tolerance: f32 sums taken in different orders
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
SMEM_BYTES_PER_S = 132 * 128 * 1.755e9  # 132 SMs x 128 B/clk x boost clock

DEVICE = "cuda"
# solve kernel checks: (n, kernel batch, plain batch, f64 oracle samples);
# the plain version is a Python loop of ~n^2/2 steps, so its batch shrinks
# (at n=64 and n=256 the batch exceeds the blocks the card keeps resident, so
# blocks walk over several graphs and reuse their scratch).  The plain
# version's time is set by its step count, not its batch, so the shapes that
# run the scratch-matrix variant (n above ~235) get tens of plain graphs too.
SW_CHECKS = ((16, 2048, 2048, 8), (64, 4096, 256, 4), (256, 1200, 32, 2),
             (320, 132, 16, 2), (768, 2, 2, 0))
# fused kernel checks: (n, kernel batch, plain batch); all kinds up to 256
FUSED_CHECKS = ((16, 2048, 2048), (64, 1024, 256), (256, 264, 16), (512, 2, 2))
CHECK_MIN_N = int(os.environ.get("SMOKE_CHECK_MIN_N", "0"))
TOO_BIG = 832                      # above both kernels' stated bounds
PLANE = ((64, 4096, "weighted"), (256, 1024, "time"))   # (n, K, cost model)
HETERO = (2048, 5, 200)            # graphs, smallest, largest
BROKER = {"u": 100_000, "users_b": 256, "steps_b": 6, "n_b": 64, "replay_u": 2_000}
LINE_SHAPE = (64, 4096)            # (n, K) of the per-kernel line


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ----------------------------------------------------------------------
# Seeded inputs (numpy), in the style of core.graph.random_wcg
# ----------------------------------------------------------------------


def random_batch(rng, b: int, n: int, *, n_valid=None, edge_prob=0.4):
    """B random connected WCGs padded to n vertices, as f32 arrays.

    ``n_valid`` (B,) gives each graph's true size; the rest is padding:
    pinned, zero weights, zero edges.  ``edge_prob`` is one density or one
    per graph.  One random vertex per graph is
    unoffloadable.  Even graphs follow ``random_wcg`` (cloud cost = half
    the local cost: the best cut offloads nearly everything); odd graphs
    draw each vertex's cloud cost between 0.2x and 1.8x its local cost, so
    that their best cut depends on the whole order of absorptions and
    merges — the inputs that tell a wrong solver from a right one.  Every
    fourth graph has small integer weights throughout, which makes scores
    and cuts tie exactly and so holds the solvers to the tie rules (lowest
    index absorbs first, a cut improves only on strict ``<``).
    Returns ``(adj, wl, wc, pinned)``.
    """
    nv = np.full(b, n) if n_valid is None else np.asarray(n_valid)
    live = np.arange(n)[None, :] < nv[:, None]                       # (b, n)
    t_local = rng.uniform(0.0, 20.0, size=(b, n)) * live
    prob = np.broadcast_to(np.asarray(edge_prob, np.float64), (b,))
    upper = np.triu(rng.random((b, n, n)) < prob[:, None, None], k=1)
    w = rng.uniform(0.0, 10.0, size=(b, n, n)) * upper
    # a chain 0-1-2-... keeps every graph connected
    chain = rng.uniform(0.0, 10.0, size=(b, n - 1))
    ar = np.arange(n - 1)
    w[:, ar, ar + 1] = np.where(upper[:, ar, ar + 1], w[:, ar, ar + 1], chain)
    w = w * (live[:, :, None] & live[:, None, :])
    adj = w + w.transpose(0, 2, 1)
    pinned = ~live
    pinned[np.arange(b), rng.integers(0, nv)] = True
    ratio = np.where(np.arange(b)[:, None] % 2 == 1,
                     rng.uniform(0.2, 1.8, size=(b, n)), 0.5)
    w_cloud = t_local * ratio
    ints = np.arange(b) % 4 == 3
    t_local[ints] = np.floor(t_local[ints])
    w_cloud[ints] = rng.integers(0, 20, size=(int(ints.sum()), n)) * live[ints]
    adj[ints] = np.floor(np.minimum(adj[ints], 3.9))
    return (
        adj.astype(np.float32),
        t_local.astype(np.float32),
        w_cloud.astype(np.float32),
        pinned,
    )


def check_density(b: int, n: int) -> np.ndarray:
    """Edge density of each graph of a kernel check: 0.4, or about six edges
    per vertex for the integer-weight family of ``random_batch`` and, four
    graphs in eight, for the other families; a batch under eight graphs is
    all sparse.
    In a dense graph of hundreds of vertices every cut but the trivial ones
    costs far more than any vertex gains, so the answer no longer depends on
    the order of absorptions; the sparse graphs keep the large shapes able to
    tell a wrong tie rule or merge from a right one."""
    i = np.arange(b)
    sparse = (i % 4 == 3) | ((i // 4) % 2 == 1) if b >= 8 else np.ones(b, bool)
    return np.where(sparse, min(0.4, 6.4 / n), 0.4)


def random_env_matrix(rng, k: int) -> np.ndarray:
    """K environments as a (K, 6) f32 matrix.  Bandwidths and speed-up are
    log-uniform over two decades, so the batch spans everything-offloaded,
    nothing-offloaded and the contested range in between."""
    def log_uniform(lo, hi):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), k))

    return np.stack([
        log_uniform(0.02, 8.0), log_uniform(0.02, 8.0), log_uniform(1.02, 6.0),
        rng.uniform(0.5, 1.5, k), rng.uniform(0.1, 0.5, k),
        rng.uniform(0.8, 2.0, k)], axis=1).astype(np.float32)


def timed(fn):
    """``(fn(), milliseconds)`` for one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def price_masks(adj, wl, wc, masks) -> np.ndarray:
    """Eq. 2 in f64: cost of each placement (True = local) on its graph."""
    adj, wl, wc = (np.asarray(a, np.float64) for a in (adj, wl, wc))
    node = np.where(masks, wl, wc).sum(-1)
    cut = masks[:, :, None] != masks[:, None, :]
    return node + (adj * cut).sum((-1, -2)) / 2.0


def hold_equal(tag, got, want, adj, wl, wc) -> dict:
    """Hold (cuts, masks) ``got`` against ``want`` on the same graphs.

    Masks must be equal; where they differ, both placements must price (in
    f64) to the same cost within tolerance — an exact tie broken the other
    way by rounding.  Cuts within rtol, atol = RTOL * C_local.  Each cut must
    also equal the f64 price of its own mask.
    """
    cuts_g, masks_g = (np.asarray(a) for a in got)
    cuts_w, masks_w = (np.asarray(a) for a in want)
    c_local = np.asarray(wl, np.float64).sum(-1)
    tol = RTOL * np.abs(cuts_w) + RTOL * c_local
    err = np.abs(cuts_g.astype(np.float64) - cuts_w.astype(np.float64))
    if not (err <= tol).all():
        i = int(np.argmax(err - tol))
        raise AssertionError(
            f"{tag}: cut mismatch on graph {i}: {cuts_g[i]} vs {cuts_w[i]}"
        )
    differ = np.nonzero((masks_g != masks_w).any(-1))[0]
    if differ.size:
        pg = price_masks(adj[differ], wl[differ], wc[differ], masks_g[differ])
        pw = price_masks(adj[differ], wl[differ], wc[differ], masks_w[differ])
        bad = np.abs(pg - pw) > tol[differ]
        if bad.any():
            raise AssertionError(
                f"{tag}: placements differ in cost on graphs {differ[bad][:8]}"
            )
    hold_own_price(tag, got, adj, wl, wc)
    return {"max_abs_err": float(err.max()), "tie_masks": int(differ.size)}


def hold_own_price(tag, got, adj, wl, wc, chunk: int = 256) -> None:
    """Every cut must be the f64 Eq.-2 price of its own placement (the
    solver's Eq.-10 value and the placement's cost are the same number)."""
    cuts, masks = (np.asarray(a) for a in got)
    for lo in range(0, len(cuts), chunk):
        sl = slice(lo, lo + chunk)
        own = price_masks(adj[sl], wl[sl], wc[sl], masks[sl])
        tol = 4 * RTOL * (np.abs(own) + np.asarray(wl[sl], np.float64).sum(-1))
        finite = cuts[sl] < 1e29  # a graph with one live vertex has no cut
        if not (np.abs(own - cuts[sl])[finite] <= tol[finite]).all():
            raise AssertionError(f"{tag}: a cut is not the price of its own mask")


def to_dev(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in arrays)


def to_host(pair):
    return tuple(t.cpu().numpy() for t in pair)


def absorb_steps(pinned: np.ndarray) -> np.ndarray:
    """Absorb steps each graph's solve needs: sum over phases of
    (n_alive - 1), with n_alive starting at n minus the folded vertices."""
    alive0 = pinned.shape[-1] - np.maximum(pinned.sum(-1) - 1, 0)
    return alive0 * (alive0 - 1) // 2


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions on the card
# ----------------------------------------------------------------------


def phase_kernel_checks(rng) -> dict:
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_reference
    from repro_torch.core.cost_models import (
        EnergyModel, ResponseTimeModel, WeightedModel,
    )
    from repro_torch.kernels import mcop_phase as K

    entries = []
    # ---- solve kernel: (n, kernel batch, plain batch, oracle samples) ----
    for n, b, b_plain, n_ref in SW_CHECKS:
        if n < CHECK_MIN_N:
            continue
        # a third of the graphs are smaller than the bucket (padding)
        nv = np.where(rng.random(b) < 0.33, rng.integers(max(2, n // 4), n + 1, b), n)
        host = random_batch(rng, b, n, n_valid=nv, edge_prob=check_density(b, n))
        dev = to_dev(host)
        got = to_host(K.mcop_stoer_wagner_kernel(*dev))
        torch.cuda.synchronize()
        entry = {"name": "mcop_stoer_wagner_kernel", "shape": [b, n, n],
                 "plain_batch": b_plain}
        if b_plain:
            sub = tuple(t[:b_plain].contiguous() for t in dev)
            want, entry["plain_ms"] = timed(lambda: K.stoer_wagner_plain(*sub))
            entry.update(hold_equal(
                f"sw n={n}", tuple(a[:b_plain] for a in got), to_host(want),
                *(a[:b_plain] for a in host[:3])))
        # the whole kernel batch, beyond what the plain version covered
        hold_own_price(f"sw n={n}", got, *host[:3])
        entry["kernel_ms"] = cuda_ms(
            lambda: K.mcop_stoer_wagner_kernel(*dev), reps=3 if n <= 256 else 1)
        # oracle samples: a sparse integer-weight graph first, then a dense
        # contested one, then the other families
        for i in (3, 1, 0, 2, 7, 5, 4, 6)[:n_ref]:
            g = WCG(host[1][i, :nv[i]], host[2][i, :nv[i]],
                    host[0][i, :nv[i], :nv[i]], ~host[3][i, :nv[i]])
            ref = mcop_reference(g)
            tol = RTOL * (abs(ref.min_cut) + g.local_cost_total)
            if abs(ref.min_cut - got[0][i]) > tol:
                raise AssertionError(
                    f"sw n={n} graph {i}: {got[0][i]} vs oracle {ref.min_cut}")
            if not (ref.local_mask == got[1][i, :nv[i]]).all():
                if abs(g.total_cost(got[1][i, :nv[i]]) - ref.min_cut) > tol:
                    raise AssertionError(f"sw n={n} graph {i}: mask vs oracle")
        entry["oracle_samples"] = n_ref
        entries.append(entry)

    # ---- fused kernel: per kind, vs plain and vs the solve kernel --------
    models = {"time": ResponseTimeModel(), "energy": EnergyModel(),
              "weighted": WeightedModel(0.5)}
    for n, k, k_plain in FUSED_CHECKS:
        if n < CHECK_MIN_N:
            continue
        adj1, t_loc, _, pin1 = random_batch(
            rng, 1, n, n_valid=[n - n // 8], edge_prob=check_density(1, n))
        data = adj1[0] / 2.0
        prof = to_dev((t_loc[0], data, np.ascontiguousarray(data.T), pin1[0]))
        env_d = torch.from_numpy(random_env_matrix(rng, k)).to(DEVICE)
        for kind in K.FUSED_MODEL_KINDS if n <= 256 else ("weighted",):
            got = to_host(K.mcop_fused_solve_kernel(*prof, env_d, kind=kind))
            torch.cuda.synchronize()
            # the graphs this kernel built, rebuilt on the host side for pricing
            wl, wc, adj = (
                t.cpu().numpy() for t in K._kernel_weights(
                    kind, 0.5, prof[0], prof[1], prof[2], env_d))
            entry = {"name": "mcop_fused_solve_kernel", "kind": kind,
                     "shape": [k, n], "plain_batch": k_plain}
            if k_plain:
                want, entry["plain_ms"] = timed(lambda: K.fused_solve_plain(
                    *prof, env_d[:k_plain].contiguous(), kind=kind))
                entry.update(hold_equal(
                    f"fused n={n} {kind}", tuple(a[:k_plain] for a in got),
                    to_host(want), adj[:k_plain], wl[:k_plain], wc[:k_plain]))
            # fused == solve kernel fed with the cost model's batch_weights
            from repro_torch.core.cost_models import EnvArrays
            bw = models[kind].batch_weights(
                prof[0], prof[1], prof[2], EnvArrays(*env_d.unbind(1)))
            via_sw = to_host(K.mcop_stoer_wagner_kernel(
                bw[2].contiguous(), bw[0].contiguous(), bw[1].contiguous(),
                prof[3][None, :].expand(k, -1).contiguous()))
            res = hold_equal(f"fused==sw n={n} {kind}", got, via_sw, adj, wl, wc)
            entry["vs_solve_kernel"] = res
            entry["kernel_ms"] = cuda_ms(
                lambda: K.mcop_fused_solve_kernel(*prof, env_d, kind=kind),
                reps=3 if n <= 256 else 1)
            entries.append(entry)

    # ---- the bounds the kernels state for themselves ---------------------
    too_big = to_dev(random_batch(rng, 1, TOO_BIG))
    for call in (
        lambda: K.mcop_stoer_wagner_kernel(*too_big),
        lambda: K.mcop_fused_solve_kernel(
            too_big[1][0], too_big[0][0], too_big[0][0], too_big[3][0],
            torch.ones((1, 6), device=DEVICE), kind="time"),
    ):
        try:
            call()
        except ValueError as e:
            if f"n={TOO_BIG}" not in str(e):
                raise
        else:
            raise AssertionError(f"a kernel accepted n={TOO_BIG}, above its bound")
    return {"phase": "kernel_checks", "entries": entries,
            "plain_note": "plain_ms is one run of the plain version at "
                          "plain_batch graphs; kernel_ms is at the full shape"}


# ----------------------------------------------------------------------
# Phase 3: solve plane at full size
# ----------------------------------------------------------------------


def random_profile(rng, n: int):
    from repro_torch.core.cost_models import AppProfile
    from repro_torch.core.graph import WCG

    adj, wl, wc, pin = random_batch(rng, 1, n)
    g = WCG(wl[0], wc[0], adj[0], ~pin[0])
    return AppProfile.from_wcg_times(g)


def random_envs(rng, k: int):
    from repro_torch.core.cost_models import EnvArrays

    return EnvArrays(*random_env_matrix(rng, k).astype(np.float64).T)


def phase_solve_plane(rng) -> dict:
    from repro_torch.core.cost_models import ResponseTimeModel, WeightedModel
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_batch, solve_envs

    models = {"weighted": WeightedModel(0.5), "time": ResponseTimeModel()}
    out = {"phase": "solve_plane", "calls": []}
    for n, k, kind in PLANE:
        model = models[kind]
        profile = random_profile(rng, n)
        envs = random_envs(rng, k)
        results = {}
        for backend in ("cuda_fused", "cuda"):
            solve_envs(profile, model, envs, backend=backend, device=DEVICE)  # warm
            t0 = time.perf_counter()
            results[backend] = solve_envs(
                profile, model, envs, backend=backend, device=DEVICE)
            dt = time.perf_counter() - t0
            out["calls"].append({
                "entry": "solve_envs", "backend": backend, "n": n, "k": k,
                "model": model.name, "seconds": dt, "graphs_per_s": k / dt})
        # the two kernels must agree with each other, placement by placement
        batch = model.build_batch(profile, envs)
        a, b = results["cuda_fused"], results["cuda"]
        cuts = [np.array([r.min_cut for r in rs]) for rs in (a, b)]
        masks = [np.stack([r.local_mask for r in rs]) for rs in (a, b)]
        out["calls"][-1]["fused_vs_cuda"] = hold_equal(
            f"solve_envs n={n}", (cuts[0], masks[0]), (cuts[1], masks[1]),
            batch.adj, batch.w_local, batch.w_cloud)

    # heterogeneous graphs of 5..200 vertices: all three buckets
    sizes = rng.integers(HETERO[1], HETERO[2] + 1, HETERO[0])
    graphs = []
    for n in sizes:
        adj, wl, wc, pin = random_batch(rng, 1, int(n))
        graphs.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    mcop_batch(graphs[:64], backend="cuda", device=DEVICE)  # warm
    t0 = time.perf_counter()
    res = mcop_batch(graphs, backend="cuda", device=DEVICE)
    dt = time.perf_counter() - t0
    for g, r in zip(graphs[::97], res[::97]):
        tol = 4 * RTOL * (abs(r.min_cut) + g.local_cost_total)
        if abs(g.total_cost(r.local_mask) - r.min_cut) > tol:
            raise AssertionError("mcop_batch: cut is not its mask's price")
        g.validate_placement(r.local_mask)
    out["calls"].append({
        "entry": "mcop_batch", "backend": "cuda", "graphs": len(graphs),
        "sizes": f"{HETERO[1]}..{HETERO[2]}", "seconds": dt, "graphs_per_s": len(graphs) / dt})
    return out


# ----------------------------------------------------------------------
# Phase 4: the broker
# ----------------------------------------------------------------------


def face_profile():
    from repro_torch.core.cost_models import AppProfile
    from repro_torch.core.graph import face_recognition_graph

    return AppProfile.from_wcg_times(
        face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0))


def device_busy_ms(prof) -> float:
    """Sum of kernel and copy time on the card over a profiler window."""
    total = 0.0
    for ev in prof.key_averages():
        total += getattr(ev, "self_device_time_total", None) or getattr(
            ev, "self_cuda_time_total", 0.0)
    return total / 1e3


def drive_broker(backend: str, device: str, u: int, users_b: int, steps_b: int,
                 profile_b, tracer=None, profile_device: bool = False):
    """The two-tenant workload; returns (batch reports, object events,
    broker, timing dict, traffic ticks).  ``profile_device`` wraps the timed
    batched ticks in ``torch.profiler`` and adds the card's busy time."""
    from repro_torch.core.cost_models import ResponseTimeModel, WeightedModel
    from repro_torch.service import (
        OffloadBroker, TrafficGenerator, run_workload, user_traces,
    )

    warmup, steps = 2, 5
    broker = OffloadBroker(backend=backend, device=device, tracer=tracer)
    broker.register("face", face_profile(), ResponseTimeModel())
    broker.register("wide", profile_b, WeightedModel(0.5))
    group = broker.register_batch("face", u, threshold=0.15, min_interval=2)
    gen = TrafficGenerator(u, seed=7, arrival_rate=max(1.0, 0.02 * u),
                           churn=0.02, initial=u)
    ticks = [gen.step() for _ in range(warmup + steps)]
    for tk in ticks[:warmup]:
        group.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
        broker.tick()
    if tracer is not None:
        tracer.clear()  # keep the timed ticks' spans only
    prof = None
    if profile_device:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    for tk in ticks[warmup:]:
        group.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
        broker.tick()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    busy_ms = None
    if prof is not None:
        prof.__exit__(None, None, None)
        busy_ms = device_busy_ms(prof)
    stage_s = {}
    if tracer is not None:
        for sp in tracer.spans():
            stage_s[sp.name] = stage_s.get(sp.name, 0.0) + sp.duration
    reports = group.drain()
    traces = user_traces(users_b, steps_b, seed=11)
    t0 = time.perf_counter()
    work = run_workload(broker, "wide", n_users=users_b, steps=steps_b,
                        threshold=0.15, min_interval=2, traces=traces)
    object_s = time.perf_counter() - t0
    timing = {"batch_seconds": batch_s, "batch_steps": steps,
              "object_seconds": object_s, "object_steps": steps_b,
              "stage_seconds": stage_s, "device_busy_ms": busy_ms}
    return reports, work.events, broker, timing, ticks


def hold_events(tag, got_events, want_events) -> int:
    """Every event's placement must match the reference replay; a mask that
    differs must price to the same cost (an exact tie).  Returns ties."""
    ties = 0
    for u, (ge, we) in enumerate(zip(got_events, want_events)):
        if len(ge) != len(we):
            raise AssertionError(f"{tag}: user {u} event count differs")
        for a, b in zip(ge, we):
            if (a.repartitioned, a.step) != (b.repartitioned, b.step):
                raise AssertionError(f"{tag}: user {u} decisions differ")
            tol = RTOL * (abs(b.result.min_cut) + abs(b.no_offload_cost))
            if abs(a.result.min_cut - b.result.min_cut) > tol:
                raise AssertionError(
                    f"{tag}: user {u} step {a.step}: cut {a.result.min_cut} "
                    f"vs reference {b.result.min_cut}")
            if not np.array_equal(a.result.local_mask, b.result.local_mask):
                if abs(a.partial_cost - b.partial_cost) > tol:
                    raise AssertionError(
                        f"{tag}: user {u} step {a.step}: placement differs")
                ties += 1
    return ties


def phase_broker(rng) -> dict:
    from repro_torch.core.cost_models import ResponseTimeModel
    from repro_torch.core.placement_cache import PlacementCache
    from repro_torch.core.session_batch import SessionBatch, tick_sessions
    from repro_torch.kernels.mcop_phase import LAUNCHES
    from repro_torch.obs.trace import Tracer

    u, users_b, steps_b = BROKER["u"], BROKER["users_b"], BROKER["steps_b"]
    profile_b = random_profile(np.random.default_rng(5), BROKER["n_b"])
    before = dict(LAUNCHES)
    tracer = Tracer()
    reports, _, broker, timing, ticks = drive_broker(
        "cuda", DEVICE, u, users_b, steps_b, profile_b, tracer=tracer,
        profile_device=bool(os.environ.get("SMOKE_PROFILE")))
    tel = broker.telemetry
    steps = timing["batch_steps"]
    out = {
        "phase": "broker", "sessions": u,
        "ticks_per_s": steps / timing["batch_seconds"],
        "us_per_user_observation": timing["batch_seconds"] / (steps * u) * 1e6,
        "batch_hits": sum(r.hits for r in reports),
        "batch_solved": sum(r.solved for r in reports),
        "batch_coalesced": sum(r.coalesced for r in reports),
        "object_users": users_b, "object_steps": steps_b,
        "object_seconds": timing["object_seconds"],
        "object_hit_rate": tel.hit_rate,
        # seconds per tick stage, summed over the timed batched ticks
        "stage_seconds": timing["stage_seconds"],
        # the card's busy share of those ticks (SMOKE_PROFILE=1), else null
        "device_busy_ms": timing["device_busy_ms"],
        "device_idle_share": None if timing["device_busy_ms"] is None else
        1.0 - timing["device_busy_ms"] / 1e3 / timing["batch_seconds"],
        # (bucket, graphs) of every solve flush: null bucket = solve_envs flush
        "flush_shapes": sorted({
            (s.attrs.get("bucket") or 16, s.attrs["batch"])
            for s in tracer.spans("stage.solve_flush")}),
    }
    for r in reports:
        if not (np.isfinite(r.partial_cost[r.active]).all()
                and r.placements.shape == (u, 9)):
            raise AssertionError("broker: batched tick report malformed")

    # one fused tick over tenant (a)'s traffic, on a fresh batch and cache
    batch = SessionBatch.create(u, 9, threshold=0.15, min_interval=2)
    batch.activate(ticks[0].arrived)
    t0 = time.perf_counter()
    fused = tick_sessions(
        batch, ticks[0].envs, profile=face_profile(), model=ResponseTimeModel(),
        cache=PlacementCache(), backend="cuda_fused", device=DEVICE,
        device_telemetry=True)
    out["fused_tick_seconds"] = time.perf_counter() - t0
    out["fused_tick"] = {"due": fused.due, "solved": fused.solved,
                         "coalesced": fused.coalesced,
                         "device_summary": fused.device_summary}
    if not all(np.isfinite(v) for v in fused.device_summary.values()):
        raise AssertionError("broker: device telemetry not finite")
    out["launches"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    out["main_path_launches"] = dict(LAUNCHES)  # since the reset before phase 3
    for name, count in out["launches"].items():
        if count <= 0:
            raise AssertionError(f"broker path never launched {name}")

    # replay at U = 2000 on the card and on the f64 reference; all must match
    small = BROKER["replay_u"]
    got = drive_broker("cuda", DEVICE, small, users_b, steps_b, profile_b)
    want = drive_broker("reference", "cpu", small, users_b, steps_b, profile_b)
    ties = hold_events("object path", got[1], want[1])
    for rg, rw in zip(got[0], want[0]):
        act = rw.active
        if not (np.array_equal(rg.active, act)
                and np.array_equal(rg.repartitioned, rw.repartitioned)):
            raise AssertionError("batched path: decisions differ from reference")
        tol = RTOL * (np.abs(rw.min_cut[act]) + rw.no_offload_cost[act])
        if not (np.abs(rg.min_cut[act] - rw.min_cut[act]) <= tol).all():
            raise AssertionError("batched path: cuts differ from reference")
        differ = (rg.placements[act] != rw.placements[act]).any(-1)
        if differ.any():
            same_cost = np.abs(rg.partial_cost[act] - rw.partial_cost[act]) <= tol
            if not same_cost[differ].all():
                raise AssertionError("batched path: placements differ from reference")
            ties += int(differ.sum())
    out["replay"] = {"sessions": small, "object_users": users_b,
                     "events_checked": sum(len(e) for e in want[1])
                     + sum(int(r.active.sum()) for r in want[0]),
                     "tie_masks": ties}
    return out


# ----------------------------------------------------------------------
# The per-kernel line: time, plain time, bound, at the solve-plane shape
# ----------------------------------------------------------------------


def measure_kernels(rng, n: int, k: int, kind: str, *, reps: int) -> dict:
    """Both kernels at one solve-plane shape: K environments on an n-vertex
    profile.  Returns per kernel: error against the plain version, time,
    plain time, and the roofline bound for this run's inputs."""
    from repro_torch.kernels import mcop_phase as K

    adj1, t_loc, _, pin1 = random_batch(rng, 1, n)
    data = adj1[0] / 2.0
    prof = to_dev((t_loc[0], data, np.ascontiguousarray(data.T), pin1[0]))
    env_d = torch.from_numpy(random_env_matrix(rng, k)).to(DEVICE)
    wl, wc, adj = (t.contiguous() for t in K._kernel_weights(
        kind, 0.5, prof[0], prof[1], prof[2], env_d))
    pin = prof[3][None, :].expand(k, -1).contiguous()
    steps = int(absorb_steps(pin.cpu().numpy()).sum())

    def sw():
        return K.mcop_stoer_wagner_kernel(adj, wl, wc, pin)

    def fused():
        return K.mcop_fused_solve_kernel(*prof, env_d, kind=kind)

    # the plain version at a batch it finishes in seconds (n^2/2 tiny steps)
    k_plain = k if n <= 64 else 16
    sub = tuple(t[:k_plain].contiguous() for t in (adj, wl, wc, pin))
    plain, plain_sw_ms = timed(lambda: K.stoer_wagner_plain(*sub))
    _, plain_fused_ms = timed(lambda: K.fused_solve_plain(
        *prof, env_d[:k_plain].contiguous(), kind=kind))
    host = tuple(t[:k_plain].cpu().numpy() for t in (adj, wl, wc))
    want = to_host(plain)
    err = {
        "sw": hold_equal(f"sw ({k},{n})", tuple(
            a[:k_plain] for a in to_host(sw())), want, *host),
        "fused": hold_equal(f"fused ({k},{n})", tuple(
            a[:k_plain] for a in to_host(fused())), want, *host),
    }

    def bound(nbytes: float, flops: float):
        by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        return max(by, op), "bytes" if by >= op else "operations"

    # every absorb step scores n candidates (subtract, compare) and adds one
    # row (n adds); every phase prices a cut and merges (about 4n operations)
    solve_flops = steps * 3 * n + k * (n - 1) * 4 * n
    sw_bytes = adj.numel() * 4 + 2 * wl.numel() * 4 + pin.numel() + k * (4 + n)
    # the fused build: 4 divisions, 3 additions, 5 multiplies/divides per edge
    fused_bytes = 2 * n * n * 4 + n * 4 + n + k * 24 + k * (4 + n)
    fused_flops = solve_flops + k * n * n * 12
    common = {"shape": [k, n], "kind": kind, "plain_batch": k_plain}
    # counted from the inputs and an assumed shared-memory rate, not measured:
    # kept out of the per-kernel line, which holds measurements and the bound
    out = {"work": {"shape": [k, n], "absorb_steps": steps,
                    "row_traffic_bytes": steps * n * 4,
                    "row_traffic_ms_computed": steps * n * 4 / SMEM_BYTES_PER_S * 1e3}}
    for key, fn, plain_ms, (b_ms, b_by) in (
        ("sw", sw, plain_sw_ms, bound(sw_bytes, solve_flops)),
        ("fused", fused, plain_fused_ms, bound(fused_bytes, fused_flops)),
    ):
        out[key] = {"max_abs_err": err[key]["max_abs_err"],
                    "tie_masks": err[key]["tie_masks"],
                    "ms": cuda_ms(fn, reps=reps), "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, **common}
    return out


def kernel_lines(rng, launches: dict) -> tuple[dict, dict]:
    """``(kernel_work line, per-kernel line)``.  The per-kernel line holds
    the contract's keys at LINE_SHAPE and the same measurements at the other
    solve-plane shape under ``other_shapes``: measured values and the
    roofline bound only.  The work line holds what was counted."""
    n, k = LINE_SHAPE
    main = measure_kernels(rng, n, k, "weighted", reps=5)
    others = [measure_kernels(rng, n2, k2, kind, reps=2)
              for n2, k2, kind in PLANE if (n2, k2) != (n, k)]
    names = {
        "sw": ("mcop_stoer_wagner_kernel", "mcop_sw.cu", 382),
        "fused": ("mcop_fused_solve_kernel", "mcop_fused.cu", 606),
    }
    work = {"phase": "kernel_work",
            "assumed_smem_bytes_per_s": SMEM_BYTES_PER_S,
            "shapes": [m["work"] for m in (main, *others)]}
    return work, {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": f"src/repro/kernels/mcop_phase.py:{line}",
         "launches": launches[name], "library_ms": None, **main[key],
         "other_shapes": [o[key] for o in others]}
        for key, (name, src, line) in names.items()
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import mcop_phase as K

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    built = build.build_all(verbose_ptxas=bool(os.environ.get("SMOKE_PTXAS")))
    if os.environ.get("SMOKE_PTXAS"):
        for name, log in built["log"].items():
            print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    nvcc = next(
        (ln.strip() for ln in subprocess.run(
            [build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True).stdout.splitlines() if "release" in ln), "unknown")
    emit({"phase": "env", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "build_seconds": built["seconds"], "built": built["built"]})

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    checks = phase_kernel_checks(rng)
    checks["seconds"] = time.perf_counter() - t0
    emit(checks)
    if os.environ.get("SMOKE_ONLY_CHECKS"):
        return 0

    K.reset_launches()  # ---- the main path starts here ----
    t0 = time.perf_counter()
    plane = phase_solve_plane(rng)
    plane["seconds"] = time.perf_counter() - t0
    plane["launches"] = dict(K.LAUNCHES)
    emit(plane)
    t0 = time.perf_counter()
    broker = phase_broker(rng)
    broker["seconds"] = time.perf_counter() - t0
    launches = broker["main_path_launches"]  # ---- and ends before the replay ----
    emit(broker)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")

    work, kernels = kernel_lines(rng, launches)
    emit(work)
    emit(kernels)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
