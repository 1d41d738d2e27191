"""One gloo world of CPU ranks for ``test_torch_sharded_families.py``.

    python tests/_torch_dist_families.py IN_DIR OUT_DIR [WORLD]

Spawns ``WORLD`` (8) ranks over a ``file://`` rendezvous in ``OUT_DIR``, on
a (data 2, model 4) mesh.  ``IN_DIR/cases.pt`` holds the cases, ``{name:
{"arch", "widths", "expert_mode", "params", "batch"}}``; each rank runs
``launch.specs.build_cell``'s training step on every case, from the
placements the cell gives, and rank 0 writes each result (loss, gradient
norm, the loss at the updated parameters, the parameters as full tensors,
their placements) to ``OUT_DIR/results.pt``.  A case with ``"x"`` instead
of a batch runs the first block's MoE layer alone on that input
(:func:`run_moe_layer`).  A case that raises records its traceback
instead.  Imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import logging
import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESH = (2, 4)   # (data, model)


def case_config(case: dict):
    from repro_torch.configs import get_config, reduce_config

    return reduce_config(get_config(case["arch"]), dtype="float32", **case["widths"])


def full(t):
    return t.full_tensor().detach().clone() if hasattr(t, "full_tensor") else t.detach().clone()


def run_case(mesh, case: dict) -> dict:
    """``build_cell``'s step on ``case``, every argument placed as the
    cell's ``in_shardings`` say."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params
    from repro_torch.train import init_opt_state

    cfg = case_config(case)
    gb, seq = case["batch"]["tokens"].shape
    mode = case.get("expert_mode", "ep_model")
    cell = build_cell(cfg, ShapeConfig("train_case", "train", seq, gb), mesh, expert_mode=mode)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    params.load_state_dict(case["params"])
    shard_params(params, mesh, expert_mode=mode)
    p_shard, o_shard, b_shard = cell.in_shardings
    opt = init_opt_state(dict(params.named_parameters()))
    batch = {k: distribute_tensor(v, mesh, b_shard[k], src_data_rank=None)
             for k, v in case["batch"].items()}
    placed = ({k: tuple(p.placements) for k, p in params.named_parameters()} == p_shard
              and {k: tuple(v.placements) for k, v in opt["mu"].items()} == o_shard["mu"])
    params, opt, loss, gnorm = cell.step_fn(params, opt, batch)
    with torch.no_grad():
        after = float(full(model.train_loss(params, batch)[0]))
    return {"loss": float(loss), "grad_norm": float(gnorm), "loss_after": after,
            "placed": placed,
            "params": {k: full(p) for k, p in params.named_parameters()},
            "placements": {k: tuple(p.placements) for k, p in params.named_parameters()}}


def run_moe_layer(mesh, case: dict) -> dict:
    """The first block's MoE layer of the sharded model on ``case["x"]``
    (placed as the residual stream: the batch over "data"): its output and
    load-balancing loss, and the gradients of ``out.sum() + aux`` with
    respect to x and the layer's parameters, as full tensors."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import ffn
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import input_shardings, shard_params

    cfg = case_config(case)
    mode = case["expert_mode"]
    params = Model(cfg, device="cpu").init(0)
    params.load_state_dict(case["params"])
    shard_params(params, mesh, expert_mode=mode)
    moe = params.blocks[0].moe
    x = distribute_tensor(case["x"], mesh, input_shardings(case["x"], mesh), src_data_rank=None)
    x.requires_grad_(True)
    out, aux = ffn.moe_forward(cfg, moe, x)
    (out.sum() + aux).backward()
    return {"out": full(out), "aux": float(full(aux)), "x_grad": full(x.grad),
            "grads": {k: full(p.grad) for k, p in moe.named_parameters()},
            "placements": {k: tuple(p.placements) for k, p in moe.named_parameters()}}


def rank_main(rank, world, out_dir, in_dir):
    torch.set_num_threads(1)
    # DTensor's notes on sequential all-reduces over two mesh dimensions
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    sys.path.insert(0, SRC)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdv')}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(data=MESH[0], model=MESH[1], device="cpu")
        cases = torch.load(os.path.join(in_dir, "cases.pt"), weights_only=False)
        results = {}
        for name, case in cases.items():
            try:
                run = run_moe_layer if "x" in case else run_case
                results[name] = run(mesh, case)
            except Exception:  # noqa: BLE001 - the test reports the traceback
                results[name] = {"error": traceback.format_exc()}
                dist.barrier()
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    in_dir, out_dir = sys.argv[1], sys.argv[2]
    world = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    mp.spawn(rank_main, args=(world, out_dir, in_dir), nprocs=world, join=True)
