#!/usr/bin/env python3
"""qwen2-7b trained sharded, and its blocks pipelined, on the GPUs of one host.

    python3 tools/torch_sharded_train.py [--world 4] [--layers 28] [--steps 3]

One process a GPU, NCCL between them (``file://`` rendezvous in a temporary
directory).  Two measurements, the smoke's phases ``train_sharded`` and
``pipeline`` at the depth one card cannot hold:

* ``train_sharded`` — qwen2-7b at published widths and ``--layers`` of its
  28 layers, bf16, remat on, 2 x 8192 tokens a step, on a (data 2, model
  2) mesh: each step's loss, seconds, B4 / B4-bwd launches and collective
  calls and bytes by kind (the backward included: autograd runs in the
  calling thread), tokens/s over the steps after the first, and each
  card's peak memory;
* ``pipeline`` — the same ``--layers`` blocks over ("pod",) of size
  ``--world`` (``--layers / --world`` blocks a stage), x (4, 8192, 3584)
  bf16, n_micro 1, 2 and 4: forward and backward seconds, per-slot time
  beside the bubble the schedule predicts, launches and collectives.

Nothing is held against an unsharded run (no card holds the whole model);
the losses must be finite and every rank must launch B4 and B4-bwd as its
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402  (beside this file)

# the smoke's shapes: qwen2-7b at published widths, bf16, 2 x 8192 tokens a
# step on (data 2, model 2); the pipeline's x (4, 8192, d_model)
TRAIN = {"arch": "qwen2-7b", "seq_len": 8192, "global_batch": 2, "mesh": (2, 2), "seed": 0,
         "lr": 1e-4}
PIPELINE = {"arch": "qwen2-7b", "batch": 4, "seq_len": 8192, "n_micro": (1, 2, 4), "seed": 0}


def train_sharded(rank: int, args) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params

    spec = TRAIN
    cfg = ranks.depth_config(spec["arch"], args.layers)
    mesh = make_mesh(spec["mesh"], ("data", "model"), device="cuda")
    full = Model(cfg, device="cuda").init(spec["seed"])
    params = ranks.module_with(cfg, shard_params(
        {k: p.detach() for k, p in full.named_parameters()}, mesh))
    del full
    torch.cuda.empty_cache()
    batches = ranks.train_batches(cfg, spec["seq_len"], spec["global_batch"], args.steps,
                                  spec["seed"])
    torch.cuda.reset_peak_memory_stats()
    run = ranks.train_run(cfg, params, batches, spec["lr"], mesh=mesh)
    steps = run["steps"]
    losses = [st["loss"] for st in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_sharded: losses {losses}")
    want = {"flash_attention_kernel": 2 * cfg.n_layers,
            "flash_attention_bwd_kernel": cfg.n_layers}
    for i, st in enumerate(steps):
        got = {k: st["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"train_sharded: rank {rank} step {i} launched {got}")
    measured = steps[1:]
    tokens = spec["seq_len"] * spec["global_batch"]
    del params
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": [st["seconds"] for st in steps],
            "tokens_per_s": tokens * len(measured) / sum(st["seconds"] for st in measured),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state_gb": run["state_bytes"] / 1e9, "launches_per_step": want,
            "collectives_per_step": measured[-1]["collectives"]}


def pipeline(rank: int, args) -> dict:
    world = dist.get_world_size()
    spec = dict(PIPELINE, blocks=args.layers, mesh=(world,))
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


def rank_main(rank: int, world: int, rdv: str, out_dir: str, args) -> None:
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the backward in the calling thread: the collective counter sees it
    torch.autograd.set_multithreading_enabled(False)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank, world_size=world)
    try:
        res = {"train_sharded": train_sharded(rank, args), "pipeline": pipeline(rank, args)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all()
    out_dir = tempfile.mkdtemp(prefix="sharded_train_")
    torch.multiprocessing.spawn(rank_main, args=(args.world, os.path.join(out_dir, "rdv"),
                                                 out_dir, args),
                                nprocs=args.world, join=True)
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(args.world)]
    for phase in ("train_sharded", "pipeline"):
        print(json.dumps({"phase": phase, "world": args.world, "layers": args.layers,
                          "backend": "nccl, one process a GPU",
                          "ranks": [r[phase] for r in ranks]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
