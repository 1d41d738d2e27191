#!/usr/bin/env python3
"""What phases ``train_sharded_families`` and ``serve_sharded`` of
``chip_smoke.py`` read for zamba2-1.2b sharded, on sound runs and on runs
with a planted fault.

    python3 tools/torch_sharded_limits.py [--seeds 0 1 2] [--variants sound ...]
    python3 tools/torch_sharded_limits.py --phase serve [--seeds 0 1 2]
        [--variants sound h0_dropped ...] [--runs zamba2-1.2b ...]

**Training** (the default):

Each run is the phase's ``TRAIN_SHARDED_HYBRID`` without its f32 replay:
zamba2-1.2b at published widths, 4 of its 38 layers, bf16, 2 x 8192 tokens,
four ranks of a (data 2, model 2) mesh as threads on one GPU, held to the
same steps unsharded on the GPU and to step 1 in float32.  A variant
changes the port in the run's own process only, while the ranks train
(the unsharded runs after them stay as they are):

* ``sound`` — the port as it is, at every ``--seeds`` seed;
* ``bc_grad_lost`` — no rank takes the gradient of Mamba2's B and C
  (``ssm._mamba_in``'s ``lead`` False everywhere);
* ``bc_grad_twice`` — every rank takes it (``lead`` True everywhere), so
  the sum over the model ranks counts it twice;
* ``f32_partials`` — every sharded product of ``common.linear`` runs in
  float32 and its partial sums (the forward's, and the input's and the
  weight's gradients in the backward) are reduced in float32 before the
  one rounding to bf16;
* ``model_only`` / ``data_only`` — the sound step on a (data 1, model 4)
  or (data 2, model 1) mesh.

Prints one JSON line a run: the errors the phase holds to its limits
(``errs``: loss, gradient norm and step-1 change against the unsharded run;
``f32``: each bf16 run's distance from the float32 step) and the ratios of
the sharded run's distances to the unsharded run's.

**Serving** (``--phase serve``): the phase's ``SERVE_SHARDED`` world with
the runs ``--runs`` (zamba2's four by default: 4 of its 38 layers in bf16,
long_500k's shape in bf16, and both at reduced widths in f32), each held to the
unsharded run on the card as the phase holds it.  A variant changes the
port's sharded route only (the unsharded runs take plain tensors):

* ``sound`` — the port as it is, at every ``--seeds`` seed;
* ``h0_dropped`` — the sharded Mamba2 decode step starts from a zero state
  instead of the cache's ``h``;
* ``ring_offset`` — every rank writes a ring cache one slot past where it
  should (``common.cache_write_ring`` at ``start + 1``);
* ``n_misplaced`` — the sharded Mamba2 step pairs each rank's block of
  ``h`` (split on N) with the next rank's block of B and C.

Prints one JSON line a run and world: each run's errors against the
unsharded run (``logit_rel``, greedy ``tokens_equal``; bf16 runs also each
run's distance from the same run in f32 and their ratio), whether the
phase's limits hold, and the seconds.

Then the GPU's name and power limit.  Run it from the repository root on
one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its phase's world and references)

import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

VARIANTS = ("sound", "bc_grad_lost", "bc_grad_twice", "f32_partials", "model_only",
            "data_only")
SERVE_VARIANTS = ("sound", "h0_dropped", "ring_offset", "n_misplaced")
SERVE_RUNS = ("zamba2-1.2b", "zamba2-1.2b_long500k", "zamba2-1.2b_f32",
              "zamba2-1.2b_long500k_f32")
MESHES = {"model_only": (1, 4), "data_only": (2, 1)}


# True while the ranks train (their forward, backward and remat's recompute,
# on whatever thread autograd runs them); False for the unsharded runs after
_RANKS = {"on": True}


def _on_rank() -> bool:
    return _RANKS["on"]


class _ReduceGrad(torch.autograd.Function):
    """``t`` itself; a ``Partial`` gradient is reduced in its own dtype."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in g.placements])


def _linear_f32(orig):
    def linear(p, x):
        if not (_on_rank() and isinstance(x, DTensor)):
            return orig(p, x)
        y = _ReduceGrad.apply(x.float()) @ _ReduceGrad.apply(p.w.float())
        y = y.redistribute(y.device_mesh, [Replicate() if pl.is_partial() else pl
                                           for pl in y.placements]).to(x.dtype)
        return y + p.b.to(y.dtype) if p.b is not None else y
    return linear


def plant(variant: str) -> None:
    """Change the port for ``variant`` in this process."""
    from repro_torch.models import attention, common, ffn, ssm, transformer

    if variant in ("bc_grad_lost", "bc_grad_twice"):
        orig, lead = ssm._mamba_in, variant == "bc_grad_twice"

        def mamba_in(cfg, heads, lead_, *args, **kw):
            return orig(cfg, heads, lead if _on_rank() else lead_, *args, **kw)
        ssm._mamba_in = mamba_in
    elif variant == "f32_partials":
        patched = _linear_f32(common.linear)
        for mod in (common, attention, ffn, ssm, transformer):
            mod.linear = patched


def plant_serve(variant: str) -> None:
    """Change the port's sharded serving route for ``variant`` in this
    process."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import common, ssm

    if variant == "h0_dropped":
        step = ssm._mamba2_step_sharded

        def dropped(cfg, p, x, state):
            return step(cfg, p, x, state._replace(h=state.h * 0))
        ssm._mamba2_step_sharded = dropped
    elif variant == "ring_offset":
        write = common.cache_write_ring

        def offset(leaf, values, start, **kw):
            return write(leaf, values, start + (1 if isinstance(leaf, DTensor) else 0), **kw)
        common.cache_write_ring = offset
    elif variant == "n_misplaced":
        local = ssm.compute_local_shape_and_global_offset

        def rolled(shape, mesh, placements):
            size, off = local(shape, mesh, placements)
            if len(shape) == 4 and Shard(3) in tuple(placements):
                off = (*off[:3], (off[3] + size[3]) % shape[3])
            return size, off
        ssm.compute_local_shape_and_global_offset = rolled


def child_serve(variant: str, args_path: str) -> None:
    """A serving run's process: the variant planted, then the phase's world."""
    plant_serve(variant)
    smoke._thread_world(*pickle.load(open(args_path, "rb")))


def run_serve(variant: str, seed: int, names: list) -> dict:
    spec = dict(smoke.SERVE_SHARDED, seed=seed,
                runs={k: v for k, v in smoke.SERVE_SHARDED["runs"].items() if k in names})
    world = spec["mesh"][0] * spec["mesh"][1]
    tmp = tempfile.mkdtemp(prefix="serve_limits_")
    args, out_path = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "world.pt")
    with open(args, "wb") as f:
        pickle.dump(("serve_sharded", spec, world, out_path), f)
    code = ("import sys; sys.path.insert(0, 'tools'); import torch_sharded_limits as t; "
            "t.child_serve(sys.argv[1], sys.argv[2])")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", code, variant, args], env=env, cwd=ROOT,
                              timeout=spec["timeout"] + 120)
    except subprocess.TimeoutExpired:
        return {"variant": variant, "seed": seed, "error": "timed out"}
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        return {"variant": variant, "seed": seed, "error": f"exit {proc.returncode}"}
    out = torch.load(out_path, weights_only=False)
    if out["failures"]:
        return {"variant": variant, "seed": seed, "error": out["failures"][0][-2000:]}
    runs = {}
    for name, run in spec["runs"].items():
        err = out["after"][name]
        row = {k: err[k] for k in ("logit_rel", "tokens_equal", "f32_sharded",
                                   "f32_unsharded") if k in err}
        if "rtol" in run:
            row["within_limits"] = bool(err["tokens_equal"] and err["logit_rel"] <= run["rtol"])
        else:
            row["f32_ratio"] = err["f32_sharded"] / max(err["f32_unsharded"], 1e-5)
            row["within_limits"] = bool(err["logit_rel"] <= run.get("logit_tol", float("inf"))
                                        and row["f32_ratio"] <= spec["f32_slack"])
        row["seconds"] = max(res[name]["seconds"] for res in out["results"])
        row["ref_seconds"] = err["ref_seconds"]
        runs[name] = row
    return {"variant": variant, "seed": seed, "runs": runs, "world_seconds": seconds,
            "f32_slack": spec["f32_slack"]}


def child(variant: str, args_path: str) -> None:
    """The run's process: the variant planted, then the phase's world."""
    plant(variant)
    after = smoke.WORLD_AFTER["train_sharded"]

    def unsharded(*args):
        _RANKS["on"] = False
        return after(*args)
    smoke.WORLD_AFTER["train_sharded"] = unsharded
    smoke._thread_world(*pickle.load(open(args_path, "rb")))


def run(variant: str, seed: int) -> dict:
    spec = {k: v for k, v in smoke.TRAIN_SHARDED_HYBRID.items() if k != "replay"}
    spec.update(seed=seed, mesh=MESHES.get(variant, spec["mesh"]))
    world = spec["mesh"][0] * spec["mesh"][1]
    tmp = tempfile.mkdtemp(prefix="sharded_limits_")
    args, out_path = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "world.pt")
    with open(args, "wb") as f:
        pickle.dump(("train_sharded", spec, world, out_path), f)
    code = ("import sys; sys.path.insert(0, 'tools'); import torch_sharded_limits as t; "
            "t.child(sys.argv[1], sys.argv[2])")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        proc = subprocess.run([sys.executable, "-c", code, variant, args], env=env, cwd=ROOT,
                              timeout=spec["timeout"] + 120)
    except subprocess.TimeoutExpired:
        return {"variant": variant, "seed": seed, "error": "timed out"}
    if proc.returncode != 0 or not os.path.exists(out_path):
        return {"variant": variant, "seed": seed, "error": f"exit {proc.returncode}"}
    out = torch.load(out_path, weights_only=False)
    if out["failures"]:
        return {"variant": variant, "seed": seed, "error": out["failures"][0][-2000:]}
    errs = out["after"]["full"]["errs"]
    f32 = errs.pop("f32")
    ratios = {k: f32["sharded"][k] / f32["unsharded"][k] for k in ("grad_norm_rel", "change_rel")}
    limits = {"grad_norm_rel": spec["grad_norm_rtol"], "change_rel": spec["change_rtol"],
              "f32_ratio": spec["f32_slack"], "loss": spec["loss_tol"],
              "param_step1": spec["param_tol"]}
    within = (errs["loss"] <= limits["loss"] and errs["param_step1"] <= limits["param_step1"]
              and errs["grad_norm_rel"] <= limits["grad_norm_rel"]
              and errs["change_rel"] <= limits["change_rel"] and errs["still_moved"] == 0
              and max(ratios.values()) <= limits["f32_ratio"])
    steps = out["results"][0]["full"]["steps"]
    return {"variant": variant, "seed": seed, "mesh": spec["mesh"], "errs": errs, "f32": f32,
            "f32_ratio": ratios, "limits": limits, "within_limits": within,
            "losses": [st["loss"] for st in steps],
            "grad_norms": [st["grad_norm"] for st in steps],
            "ref_losses": [st["loss"] for st in out["after"]["full"]["ref_steps"]],
            "step_seconds": [st["seconds"] for st in steps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=" ".join(__doc__.split("\n\n")[0].split()))
    ap.add_argument("--phase", choices=("train", "serve"), default="train")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--variants", nargs="+", choices=sorted(set(VARIANTS + SERVE_VARIANTS)))
    ap.add_argument("--runs", nargs="+", default=list(SERVE_RUNS),
                    choices=list(smoke.SERVE_SHARDED["runs"]))
    args = ap.parse_args(argv)
    allowed = SERVE_VARIANTS if args.phase == "serve" else VARIANTS
    variants = args.variants or list(allowed)
    if set(variants) - set(allowed):
        ap.error(f"--phase {args.phase} takes the variants {allowed}")
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all()
    failed = 0
    for variant in variants:
        for seed in (args.seeds if variant == "sound" else args.seeds[:1]):
            res = (run_serve(variant, seed, args.runs) if args.phase == "serve"
                   else run(variant, seed))
            failed += "error" in res
            print(json.dumps(res), flush=True)
    print(smoke.gpu_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
