#!/usr/bin/env python3
"""A serving cell of ``launch.specs.build_cell`` sharded on the GPUs of one host.

    python3 tools/torch_sharded_serve.py --arch qwen2-7b --shape decode_32k
        [--steps 16] [--batch N ...] [--world 4]

One process a GPU, NCCL between them (``file://`` rendezvous in a temporary
directory), on a (data 2, model 2) mesh: the counterpart over NCCL of the
smoke's phase ``serve_sharded``.  The cell runs at its own shape, published
widths and all layers, in bf16:

* ``decode_32k`` / ``long_500k`` (a decode cell): the cache made on each
  rank for its own shards (``torch_dist_ranks.mesh_cache``: N(0, 1/4) from
  the seed, at ``length`` = the cell's positions less 64 for decode_32k, less
  8 for long_500k), then ``--steps`` greedy steps of the decode cell;
* ``prefill_32k`` (a prefill cell): seeded prompts of the cell's length into
  an empty cache at each ``--batch`` in turn (the global batch: the cell's
  own, 32, may not fit; the largest that ran is reported), then ``--steps``
  decode steps.

For each: tokens/s (prefill: the prompt tokens over the prefill's seconds;
decode: the batch over each step's seconds, after a first warm-up step),
each card's peak memory, the cache's bytes a card holds, the collective
calls and bytes of a rank's decode step (``CommDebugMode``'s functional
collectives, by kind), and B4's and B5's launches against those the
prefill calls for.  Then an f32 replay at reduced widths (``REPLAY``): the
same cell sharded, against the port's unsharded run on rank 0's card,
greedy tokens ``==`` and logits within 1e-5 of the largest.  Nothing at
full size is held against an unsharded run: no card holds the cache.
Prints one JSON line a run, then the GPUs' name and power limit.  Run it
from the repository root; ``--world`` GPUs needed.
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

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402  (beside this file)

MESH = (2, 2)
SEED = 0
# the decode cells' cache length below their positions: room for the steps
HEADROOM = {"decode_32k": 64, "long_500k": 8}
# the f32 replay: reduced widths, four layers at batch 2 (``state_shardings``
# splits over "data" the first axis of the batch's size: two layers at batch
# 2 would put the layers there), a prompt above 4096 tokens for the prefill
# cell (B4's route)
REPLAY = {"widths": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                         vocab_size=256, n_layers=4),
          "prefill": {"prompt_len": 4160, "batch": 2, "max_len": 4224},
          "decode": {"batch": 2, "max_len": 8192, "length": 8000},
          "long": {"batch": 1, "max_len": 8192, "length": 8000},
          "steps": 4, "rtol": 1e-5}


def _cfg(arch: str, replay: bool):
    from repro_torch.configs import get_config, reduce_config

    if replay:
        widths = dict(REPLAY["widths"])
        if get_config(arch).family != "dense":
            widths.pop("n_layers")
            widths.pop("n_heads")
            widths.pop("n_kv_heads")
        return reduce_config(get_config(arch), dtype="float32", **widths)
    return get_config(arch)


def _summary(res: dict, bsz: int, prompt_len: int | None) -> dict:
    dec = res["decode_seconds"]
    out = {"batch": bsz, "length": res["length"], "decode_step_seconds": dec,
           "decode_tokens_per_s": bsz * (len(dec) - 1) / sum(dec[1:]) if len(dec) > 1 else None,
           "cache_gb_per_card": res["cache_bytes"] / 1e9,
           "collectives_per_decode_step": res["collectives"][-1],
           "collective_bytes_per_decode_step": ranks.collective_bytes(res["collectives"][-1]),
           "decode_launches": res["decode_launches"][-1]}
    if prompt_len:
        out.update({"prompt_len": prompt_len, "prefill_seconds": res["prefill_seconds"],
                    "prefill_tokens_per_s": bsz * prompt_len / res["prefill_seconds"],
                    "prefill_launches": res["prefill_launches"]})
    return out


def full_run(rank: int, args, mesh, bsz: int) -> dict:
    """The cell at its shape, published widths, on ``mesh``."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params

    shape = SHAPES[args.shape]
    cfg = _cfg(args.arch, replay=False)
    full = Model(cfg, device=ranks.DEVICE).init(SEED)
    params = ranks.module_with(cfg, shard_params(
        {k: p.detach() for k, p in full.named_parameters()}, mesh))
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if shape.kind == "prefill":
        batch = ranks.serve_batch(cfg, shape.seq_len, bsz, SEED)
        res = ranks.serve_run(cfg, params, batch=batch, max_len=shape.seq_len,
                              steps=args.steps, mesh=mesh, keep=False)
        want = ranks.serve_launches(cfg, shape.seq_len)
    else:
        cell = build_cell(cfg, shape, mesh)
        cache = ranks.mesh_cache(cfg, bsz, shape.seq_len, mesh, cell.in_shardings[2], seed=SEED,
                                 length=shape.seq_len - HEADROOM[args.shape])
        gen = torch.Generator(device=ranks.DEVICE).manual_seed(SEED + 1)
        start = torch.randint(1, cfg.vocab_size, (bsz, 1), generator=gen, device=ranks.DEVICE)
        res = ranks.serve_run(cfg, params, cache=cache, start=start, bsz=bsz,
                              max_len=shape.seq_len, steps=args.steps, mesh=mesh, keep=False)
        want = None
        del cache
    out = _summary(res, bsz, shape.seq_len if shape.kind == "prefill" else None)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if want is not None and res["prefill_launches"] != want:
        raise AssertionError(f"rank {rank}: the prefill launched {res['prefill_launches']}, "
                             f"expected {want}")
    if any(v for v in res["decode_launches"][-1].values()):
        raise AssertionError(f"rank {rank}: a decode step launched {res['decode_launches']}")
    del params
    torch.cuda.empty_cache()
    return out


def replay_run(rank: int, args, mesh) -> dict:
    """The f32 replay at reduced widths: sharded, then (rank 0) unsharded."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params

    shape = SHAPES[args.shape]
    cfg = _cfg(args.arch, replay=True)
    whole = {k: p.detach() for k, p in Model(cfg, device=ranks.DEVICE).init(SEED).named_parameters()}
    params = ranks.module_with(cfg, shard_params(whole, mesh))
    steps = REPLAY["steps"]
    if shape.kind == "prefill":
        r = REPLAY["prefill"]
        batch = ranks.serve_batch(cfg, r["prompt_len"], r["batch"], SEED)
        got = ranks.serve_run(cfg, params, batch=batch, max_len=r["max_len"], steps=steps,
                              mesh=mesh)
        ref_kw = {"batch": batch}
    else:
        r = REPLAY["long" if args.shape == "long_500k" else "decode"]
        cache = ranks.seeded_cache(cfg, r["batch"], r["max_len"], r["length"], SEED)
        gen = torch.Generator(device=ranks.DEVICE).manual_seed(SEED + 1)
        start = torch.randint(1, cfg.vocab_size, (r["batch"], 1), generator=gen, device=ranks.DEVICE)
        cell = build_cell(cfg, ShapeConfig("replay", "decode", r["max_len"], r["batch"]), mesh)
        placed = _place(cache, cell.in_shardings[2], mesh)
        got = ranks.serve_run(cfg, params, cache=placed, start=start, bsz=r["batch"],
                              max_len=r["max_len"], steps=steps, mesh=mesh)
        ref_kw = {"cache": cache, "start": start, "bsz": r["batch"]}
    dist.barrier()
    if rank != 0:
        return {}
    ref = ranks.serve_run(cfg, ranks.module_with(cfg, whole), max_len=r["max_len"],
                          steps=steps, **ref_kw)
    scale = max(float(t.abs().max()) for t in ref["logits"])
    err = max(float((a - b).abs().max()) for a, b in zip(got["logits"], ref["logits"]))
    same = all(torch.equal(a, b) for a, b in zip(got["tokens"], ref["tokens"]))
    return {"widths": REPLAY["widths"], **{k: v for k, v in r.items()}, "steps": steps,
            "logit_rel": err / scale, "tokens_equal": same, "rtol": REPLAY["rtol"],
            "ok": same and err <= REPLAY["rtol"] * scale}


def _place(tree, shardings, mesh):
    from repro_torch.runtime.sharding import place

    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], mesh) for k, v in tree.items()}
    return place(tree, mesh, shardings) if isinstance(tree, torch.Tensor) else tree


def rank_main(rank: int, world: int, rdv: str, out_dir: str, args) -> None:
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh(MESH, ("data", "model"), device=ranks.DEVICE)
        replay = replay_run(rank, args, mesh)
        if rank == 0:
            with open(os.path.join(out_dir, "replay.json"), "w") as f:
                json.dump(replay, f)
        dist.barrier()
        for bsz in args.batch:
            res = full_run(rank, args, mesh, bsz)
            with open(os.path.join(out_dir, f"b{bsz}_r{rank}.json"), "w") as f:
                json.dump(res, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--shape", default="decode_32k",
                    choices=("prefill_32k", "decode_32k", "long_500k"))
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, nargs="*", default=None,
                    help="global batches to run in turn (default: the cell's own)")
    args = ap.parse_args(argv)
    args.batch = args.batch or [SHAPES[args.shape].global_batch]
    if torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    build.build_all()
    out_dir = tempfile.mkdtemp(prefix="sharded_serve_")
    failed = None
    try:
        torch.multiprocessing.spawn(rank_main, args=(args.world, os.path.join(out_dir, "rdv"),
                                                     out_dir, args),
                                    nprocs=args.world, join=True)
    except Exception as err:  # noqa: BLE001 - a larger batch may not fit; report what ran
        failed = f"{type(err).__name__}: {str(err)[-2000:]}"
    replay_path = os.path.join(out_dir, "replay.json")
    replay = json.load(open(replay_path)) if os.path.exists(replay_path) else None
    runs = []
    for bsz in args.batch:
        paths = [os.path.join(out_dir, f"b{bsz}_r{r}.json") for r in range(args.world)]
        if all(os.path.exists(p) for p in paths):
            runs.append({"global_batch": bsz, "ranks": [json.load(open(p)) for p in paths]})
    print(json.dumps({"tool": "torch_sharded_serve", "arch": args.arch, "shape": args.shape,
                      "mesh": dict(zip(("data", "model"), MESH)), "world": args.world,
                      "backend": "nccl, one process a GPU", "dtype": "bfloat16",
                      "replay": replay, "runs": runs, "failed": failed}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    ok = replay is not None and replay.get("ok") and runs
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
