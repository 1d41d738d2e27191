"""One run of a cell: set-up, the measured window, the reference, the line.

The order is fixed: set-up (``setup_s`` runs from the process's start to
the window's start); the window (with ``--trace 1``, its first units under
the profiler); the peak memory read; the program's state freed; the trace
reduced; the reference's comparison; the check that no JAX module was
loaded; the result.  The numbers compared end standard error, and the
result's line carries them last, under ``checks``."""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench.harness.cell import Cell, load_cell, load_module, metric_reader
from bench.harness.tracer import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 160   # a kernel's name in the breakdown is cut to this many characters


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def layer_metrics(cell: Cell, driver, tracer: Tracer) -> dict:
    """The cell's per-layer metrics that their readers find something to
    read for."""
    ctx = driver.layer_context(tracer)
    ctx.update(trace=tracer.summary, counted=tracer.counted,
               kernel_modules={k: load_module("kernels", k) for k in driver.kernels})
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)`` of the numbers a comparison gave (``{name:
    (value, detail)}``) under the cell's limits: correct where each number
    the limits name is at or under its limit."""
    checks = {n: {"value": numbers[n][0], "limit": lim, "at": numbers[n][1]}
              for n, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> dict:
    """Run the cell on ``device``; returns the result line's object."""
    import torch

    driver = load_module("drivers", cell.traffic["kind"]).Driver(cell, seed, device)
    driver.setup()
    tracer = Tracer(trace, cell.traffic.get("trace_units", 0), driver.kernels, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    driver.measure(seconds, tracer)
    t_closed = time.perf_counter()
    dev = device_info(device, cell.chips)
    driver.release()
    left = torch.cuda.memory_allocated() if cuda else 0
    tracer.finish()
    t_ref = time.perf_counter()
    within, checks = judge(driver.check(), cell.limits)
    print(f"bench: set-up {setup_s:.1f} s, window {t_closed - t_window:.1f} s, trace reduced "
          f"in {t_ref - t_closed:.1f} s, reference {time.perf_counter() - t_ref:.1f} s; "
          f"{left / 1e9:.2f} GB left allocated after the program's state was freed",
          file=sys.stderr)
    ok = within and driver.attempted > 0 and not driver.failed
    if trace:
        metrics = layer_metrics(cell, driver, tracer)
        s = tracer.summary
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        breakdown = {"device_ops": [[n[:NAME_CHARS], v] for n, v in s.top_kernels()],
                     "idle_gaps": [[n[:NAME_CHARS], v] for n, v in s.top_gaps()]}
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s,
                      peak_memory_gb=dev["memory_peak_bytes"] / 1e9)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    result = {"correct": ok, "attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv, *, t_process: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} GPU(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}; {c['at']}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
