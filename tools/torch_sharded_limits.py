#!/usr/bin/env python3
"""What phase ``train_sharded_families`` of ``chip_smoke.py`` reads for
zamba2-1.2b trained sharded, on sound runs and on runs with a planted fault.

    python3 tools/torch_sharded_limits.py [--seeds 0 1 2] [--variants sound ...]

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
the sharded run's distances to the unsharded run's; then the GPU's name and
power limit.  Run it from the repository root on one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its phase's world and references)

import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

VARIANTS = ("sound", "bc_grad_lost", "bc_grad_twice", "f32_partials", "model_only",
            "data_only")
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all()
    failed = 0
    for variant in args.variants:
        for seed in (args.seeds if variant == "sound" else args.seeds[:1]):
            res = run(variant, seed)
            failed += "error" in res
            print(json.dumps(res), flush=True)
    print(smoke.gpu_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
