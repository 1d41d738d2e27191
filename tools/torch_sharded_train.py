#!/usr/bin/env python3
"""A model trained sharded, and qwen2-7b's blocks pipelined, on the GPUs of one host.

    python3 tools/torch_sharded_train.py [--arch qwen2-7b] [--layers N] [--steps 3]
        [--expert-mode ep_model] [--resume-check] [--world 4]

One process a GPU, NCCL between them (``file://`` rendezvous in a temporary
directory).  Two measurements, the smoke's phases ``train_sharded`` /
``train_sharded_families`` and ``pipeline`` at the depth one card cannot
hold:

* ``train_sharded`` — ``--arch`` at published widths and ``--layers`` of its
  layers (all by default), bf16, remat on, 2 x 8192 tokens a step, on a
  (data 2, model 2) mesh, experts laid out by ``--expert-mode``: each
  step's loss, seconds, kernel launches (B4, B4-bwd, B5, B5-bwd) against
  the launches the step calls for, collective calls and bytes by kind (the
  backward included: autograd runs in the calling thread), tokens/s over
  the steps after the first, and each card's peak memory;
* ``pipeline`` (the dense family only: the stages are decoder blocks) —
  the same ``--layers`` blocks over ("pod",) of size ``--world``
  (``--layers / --world`` blocks a stage), x (4, 8192, d_model) bf16,
  n_micro 1, 2 and 4: forward and backward seconds, per-slot time beside
  the bubble the schedule predicts, launches and collectives.

``--resume-check`` saves the sharded state (parameters and AdamW's moments
and step, ``checkpoint.CheckpointStore``: gathered whole, written by rank
0) after step 1 of ``train_sharded``, then starts a fresh process group
in new processes, restores it onto the same mesh and runs the remaining
steps on the same batches: their losses and gradient norms must equal the
first run's bit for bit (deterministic algorithms on in both runs).

Nothing is held against an unsharded run (no card holds the whole model);
the losses must be finite and every rank must launch the kernels its
layers call for.  A rank's work is ``tools/torch_dist_ranks.py``, which the
smoke's phases run too.  Prints one JSON line a phase, then the GPUs' name and
power limit.  Run it from the repository root; ``--world`` GPUs needed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402  (beside this file)

# the smoke's shapes: published widths, bf16, 2 x 8192 tokens a step on
# (data 2, model 2); the pipeline's x (4, 8192, d_model)
TRAIN = {"seq_len": 8192, "global_batch": 2, "mesh": (2, 2), "seed": 0, "lr": 1e-4}
RESUME_AT = 1   # --resume-check: the state saved after this many steps
PIPELINE = {"arch": "qwen2-7b", "batch": 4, "seq_len": 8192, "n_micro": (1, 2, 4), "seed": 0}


def _state_tree(params, opt_state) -> dict:
    return {"params": dict(params.named_parameters()), "mu": opt_state["mu"],
            "nu": opt_state["nu"], "step": opt_state["step"]}


def train_sharded(rank: int, args) -> dict:
    """``args.arch`` trained sharded; with ``args.resume_check`` the state
    after step RESUME_AT is saved under ``args.ckpt``."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params

    spec = TRAIN
    cfg = ranks.depth_config(args.arch, args.layers)
    mesh = make_mesh(spec["mesh"], ("data", "model"), device="cuda")
    full = Model(cfg, device="cuda").init(spec["seed"])
    params = ranks.module_with(cfg, shard_params(
        {k: p.detach() for k, p in full.named_parameters()}, mesh,
        expert_mode=args.expert_mode))
    del full
    torch.cuda.empty_cache()
    batches = ranks.train_batches(cfg, spec["seq_len"], spec["global_batch"], args.steps,
                                  spec["seed"])
    store = CheckpointStore(args.ckpt) if args.resume_check else None

    def save(i, params_, opt_state):
        if store is not None and i + 1 == RESUME_AT:
            t0 = time.perf_counter()
            store.save(RESUME_AT, _state_tree(params_, opt_state))
            save_s.append(time.perf_counter() - t0)

    save_s: list = []
    torch.cuda.reset_peak_memory_stats()
    run = ranks.train_run(cfg, params, batches, spec["lr"], mesh=mesh, after_step=save)
    steps = run["steps"]
    losses = [st["loss"] for st in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_sharded: losses {losses}")
    want = ranks.step_launches(cfg, spec["seq_len"])
    for i, st in enumerate(steps):
        if st["launches"] != want:
            raise AssertionError(f"train_sharded: rank {rank} step {i} launched "
                                 f"{st['launches']}, expected {want}")
    measured = [st for i, st in enumerate(steps) if i > 0]
    tokens = spec["seq_len"] * spec["global_batch"]
    del params
    torch.cuda.empty_cache()
    return {"arch": args.arch, "layers": cfg.n_layers, "expert_mode": args.expert_mode,
            "losses": losses, "grad_norms": [st["grad_norm"] for st in steps],
            "step_seconds": [st["seconds"] for st in steps],
            "tokens_per_s": tokens * len(measured) / sum(st["seconds"] for st in measured),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state_gb": run["state_bytes"] / 1e9, "launches_per_step": want,
            "collectives_per_step": measured[-1]["collectives"],
            "save_seconds": save_s}


def resumed(rank: int, args) -> dict:
    """A fresh process group: the state saved after step RESUME_AT restored
    onto the same mesh, then the remaining steps on the same batches."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import param_shardings, placements

    spec = TRAIN
    cfg = ranks.depth_config(args.arch, args.layers)
    mesh = make_mesh(spec["mesh"], ("data", "model"), device="cuda")
    like = Model(cfg, device="meta").init()
    shard = param_shardings(like, mesh, expert_mode=args.expert_mode)
    tree_like = {"params": {k: p for k, p in like.named_parameters()},
                 "mu": {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                        for k, p in like.named_parameters()},
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
    tree_like["nu"] = dict(tree_like["mu"])
    repl = placements((), mesh)
    t0 = time.perf_counter()
    state, _ = CheckpointStore(args.ckpt).restore(
        RESUME_AT, tree_like, device=f"cuda:{rank}", mesh=mesh,
        shardings={"params": shard, "mu": shard, "nu": dict(shard), "step": repl})
    restore_s = time.perf_counter() - t0
    params = ranks.module_with(cfg, state["params"])
    opt = {"mu": state["mu"], "nu": state["nu"], "step": state["step"].full_tensor()}
    batches = ranks.train_batches(cfg, spec["seq_len"], spec["global_batch"], args.steps,
                                  spec["seed"])[RESUME_AT:]
    run = ranks.train_run(cfg, params, batches, spec["lr"], mesh=mesh, opt_state=opt,
                          first_step=RESUME_AT)
    return {"losses": [st["loss"] for st in run["steps"]],
            "grad_norms": [st["grad_norm"] for st in run["steps"]],
            "restore_seconds": restore_s}


def pipeline(rank: int, args) -> dict:
    world = dist.get_world_size()
    spec = dict(PIPELINE, arch=args.arch, mesh=(world,),
                blocks=ranks.depth_config(args.arch, args.layers).n_layers)
    shared = ranks.setup_pipeline(spec)
    del shared["stacked"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = ranks.rank_pipeline(rank, world, spec, shared, gather=False)
    per_stage = args.layers // world
    out = []
    for n_micro, res in runs.items():
        want = {"flash_attention_kernel": 2 * per_stage * n_micro,
                "flash_attention_bwd_kernel": per_stage * n_micro}
        got = {k: res["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"pipeline: rank {rank} n_micro {n_micro} launched {got}")
        slots = n_micro + world - 1
        out.append({"n_micro": n_micro, "slots": slots, "bubble_predicted": (world - 1) / slots,
                    "forward_seconds": res["forward_seconds"], "seconds": res["seconds"],
                    "forward_ms_per_slot": res["forward_seconds"] / slots * 1e3,
                    "tokens_per_s": spec["batch"] * spec["seq_len"] / res["seconds"],
                    "launches": want, "collectives": res["collectives"]})
    return {"runs": out, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def rank_main(rank: int, world: int, rdv: str, out_dir: str, args, stage: str) -> None:
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.resume_check:   # both runs: the same algorithms, so the same bits
        torch.use_deterministic_algorithms(True, warn_only=True)
    # the backward in the calling thread: the collective counter sees it
    torch.autograd.set_multithreading_enabled(False)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank, world_size=world)
    try:
        if stage == "resumed":
            res = {"resumed": resumed(rank, args)}
        else:
            res = {"train_sharded": train_sharded(rank, args)}
            if ranks.depth_config(args.arch).family == "dense":
                res["pipeline"] = pipeline(rank, args)
        with open(os.path.join(out_dir, f"{stage}{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--layers", type=int, default=None, help="default: all of the arch's")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--expert-mode", default="ep_model", choices=("ep_model", "ep_data_tp_model"))
    ap.add_argument("--resume-check", action="store_true")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.resume_check and args.steps <= RESUME_AT:
        print(f"--resume-check needs more than {RESUME_AT} steps", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all()
    if args.resume_check:   # cuBLAS's deterministic workspace, in every rank
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out_dir = tempfile.mkdtemp(prefix="sharded_train_")
    args.ckpt = os.path.join(out_dir, "ckpt")
    stages = ("train", "resumed") if args.resume_check else ("train",)
    for stage in stages:   # each a process group of its own
        torch.multiprocessing.spawn(
            rank_main, args=(args.world, os.path.join(out_dir, f"rdv_{stage}"), out_dir, args,
                             stage), nprocs=args.world, join=True)
    res = {stage: [json.load(open(os.path.join(out_dir, f"{stage}{r}.json")))
                   for r in range(args.world)] for stage in stages}
    phases = [p for p in ("train_sharded", "pipeline") if p in res["train"][0]]
    for phase in phases:
        print(json.dumps({"phase": phase, "world": args.world, "arch": args.arch,
                          "layers": res["train"][0]["train_sharded"]["layers"],
                          "backend": "nccl, one process a GPU",
                          "ranks": [r[phase] for r in res["train"]]}), flush=True)
    if args.resume_check:
        first = res["train"][0]["train_sharded"]
        again = res["resumed"][0]["resumed"]
        same = (first["losses"][RESUME_AT:] == again["losses"]
                and first["grad_norms"][RESUME_AT:] == again["grad_norms"])
        print(json.dumps({"phase": "resume_check", "arch": args.arch, "saved_after": RESUME_AT,
                          "first_run": {"losses": first["losses"],
                                        "grad_norms": first["grad_norms"],
                                        "save_seconds": first["save_seconds"]},
                          "resumed": again, "bit_for_bit": same}), flush=True)
        if not same:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
