"""The control of a cell's comparison: the reference put in the program's
place, computed one precision below the configuration's (bfloat16 ->
float8 e4m3 operands of every product with a weight, ``reference.common``),
read by the cell's own numbers at the cell's own size and judged by the
harness's own comparison (``main.judge``) under the cell's limits.  It has
to come out not correct; its readings set the upper end of each limit.

    python3 bench/controls/control.py --workload zamba2-1.2b.train-8k --seeds 11 12 13

Training: per seed, the program's set-up steps (the steps its check reads,
through the window's own call and feed), then the reference's first steps
in float32, in the control's precision, and with ``--faults half_batch``
over the first half of each batch, all from the same weights and batches;
each side's numbers against the float32 reference.  ``--program-only``
seeds read the program alone.  Serving: per seed, a short window of the
program at the cell's load, then over the requests its check reads the
reference in float32 and in the control's precision; the control's number
is read at each served position from the token it puts first.

Prints one JSON line per seed: for each side, ``correct`` and the numbers
the limits compare, and for training the sign flips at other magnitude
quantiles (``flips``) beside them.  Needs the GPU the cell runs on; the
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]

FLIP_QUANTILES = (None, 0.5, 0.75, 0.9)


def _judged(cell, numbers: dict) -> dict:
    from bench.harness.main import judge

    correct, checks = judge(numbers, cell.limits)
    return {"correct": correct, "checks": {n: c["value"] for n, c in checks.items()}}


def train_control(cell, seed: int, device, precision: str = "fp8", faults: tuple = (),
                  program_only: bool = False) -> dict:
    import torch

    from bench.drivers import train as drv
    from bench.reference import train as ref_train

    d = drv.Driver(cell, seed, device)
    d.setup()
    d.release()
    args = drv.reference_inputs(cell, seed, device, d.specs)
    family, weights, m, batches, opt = args
    ref = ref_train.train_steps(*args)
    keep = drv.kept_leaves(ref)

    def side(run: dict) -> dict:
        out = _judged(cell, drv.readings(run, ref))
        out["flips"] = {}
        for q in FLIP_QUANTILES:
            flips, total = drv.sign_flips(run["sign1"], ref["grad1"], keep, q)
            out["flips"]["all" if q is None else f"q{q}"] = flips / total
        return out

    def steps_of(low: dict) -> dict:
        return {"sign1": {n: torch.sign(g).to(torch.int8) for n, g in low["grad1"].items()},
                "change": low["change"]}

    out = {"program": side({"sign1": d.sign1, "change": d.change})}
    if program_only:
        return out
    out["control"] = side(steps_of(ref_train.train_steps(*args, precision=precision)))
    if "half_batch" in faults:
        # the fault planted in the reference put in the program's place:
        # each step's mean over the first half of its rows alone
        half = [(tok[: len(tok) // 2], lab[: len(lab) // 2]) for tok, lab in batches]
        out["half_batch"] = side(steps_of(ref_train.train_steps(family, weights, m, half, opt)))
    return out


def serve_control(cell, seed: int, device, seconds: float, precision: str = "fp8") -> dict:
    import torch

    from bench.drivers.closed_waves import Driver
    from bench.harness import weights as weights_lib
    from bench.harness.cell import load_module
    from bench.harness.tracer import Tracer
    from bench.reference import serve as ref_serve

    d = Driver(cell, seed, device)
    d.setup()
    d.measure(seconds, Tracer(False, 0, [], device))
    d.release()
    uids = d.pick()
    weights = weights_lib.draw(d.specs, cell.config["init"], seed, device)
    family = load_module("reference", cell.model["family"])
    k, b = cell.traffic["new_tokens"], cell.traffic["check_batch"]
    program, control = [], []
    for rows, served, _ in d.rows(uids):
        ref = ref_serve.reference_logits(family, weights, cell.model, rows, k, batch=b)
        low = ref_serve.reference_logits(family, weights, cell.model, rows, k, batch=b,
                                         precision=precision)
        program.append(ref_serve.served_gaps(ref, served).cpu())
        control.append(ref_serve.served_gaps(ref, low.argmax(dim=-1)).cpu())
        del ref, low
        torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    return {"program": _judged(cell, {"logit_gap": (float(torch.cat(program).max()), "")}),
            "control": _judged(cell, {"logit_gap": (float(torch.cat(control).max()), "")}),
            "requests": len(uids)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", type=int, nargs="*", default=[],
                    help="training seeds read for the program alone")
    ap.add_argument("--faults", nargs="*", default=[], choices=["half_batch"],
                    help="training faults to read beside the control")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the serving window (one wave or more at the cell's load)")
    args = ap.parse_args(argv)
    # the caches and the cuBLAS workspace as ``bench/run.py`` sets them
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" / "torch_extensions")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("control: no GPU", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds + args.program_only:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            out = train_control(cell, seed, "cuda", faults=tuple(args.faults),
                                program_only=seed in args.program_only)
        else:
            out = serve_control(cell, seed, "cuda", args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "sides": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
