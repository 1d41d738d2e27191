"""One gloo world of CPU ranks for ``test_torch_distributed.py``.

    python tests/_torch_dist_world.py IN_DIR OUT_DIR [WORLD]

Spawns ``WORLD`` (8) ranks over a ``file://`` rendezvous in ``OUT_DIR`` and
runs every scenario in each of them, in order: the port's counterparts of
``tests/test_distributed.py``.  Inputs come from ``IN_DIR`` (written by the
test module: the reduced model's parameters, carried over from the JAX
package, and the batches); rank 0 writes every result, as full tensors, to
``OUT_DIR/results.pt``.  Imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
# the reduced qwen2-7b of tests/test_distributed.py, widened to divide the meshes
WIDE = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
            dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def wide_config(**over):
    from repro_torch.configs import get_config, reduce_config

    return reduce_config(get_config("qwen2-7b"), **{**WIDE, **over})


def full(t):
    return t.full_tensor().detach().clone() if hasattr(t, "full_tensor") else t.detach().clone()


def scenario_place(mesh_dm):
    """shard_params places wq as (None, "model") and the forward runs."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.transformer import Model
    from repro_torch.runtime import input_shardings, placements, shard_params

    model = Model(wide_config(), device="cpu")
    params = shard_params(model.init(0), mesh_dm)
    wq = params.get_parameter("blocks.0.attn.wq.w")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int64),
             "labels": torch.zeros((4, 8), dtype=torch.int64)}
    pl = input_shardings(batch, mesh_dm)
    batch = {k: distribute_tensor(v, mesh_dm, pl[k], src_data_rank=None) for k, v in batch.items()}
    loss, _ = model.train_loss(params, batch)
    return {"wq": tuple(wq.placements), "wq_want": placements((None, "model"), mesh_dm),
            "loss": float(loss.full_tensor())}


def loss_at(model, params, batch) -> float:
    """The loss of ``batch`` at ``params`` as they stand (after a step: the
    loss the next step would report, which moves only if the update was
    written into the parameters)."""
    with torch.no_grad():
        return float(full(model.train_loss(params, batch)[0]))


def scenario_step(mesh_dm, in_dir, tag):
    """One sharded AdamW step (``make_train_step``) of the reduced model."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.transformer import Model
    from repro_torch.runtime import input_shardings, shard_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step

    inputs = torch.load(os.path.join(in_dir, f"step_{tag}.pt"))
    model = Model(wide_config(**inputs["widths"]), device="cpu")
    params = model.init(0)
    params.load_state_dict(inputs["params"])
    shard_params(params, mesh_dm)
    pl = input_shardings(inputs["batch"], mesh_dm)
    batch = {k: distribute_tensor(v, mesh_dm, pl[k], src_data_rank=None)
             for k, v in inputs["batch"].items()}
    tcfg = TrainConfig(optimizer=AdamWConfig(**OPT))
    state = init_train_state(params, tcfg)
    step = make_train_step(model.train_loss, tcfg)
    _, opt, _, m = step(state.params, state.opt_state, None, batch, None)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "loss_after": loss_at(model, params, batch),
            "params": {k: full(p) for k, p in params.named_parameters()},
            "mu": {k: full(v) for k, v in opt["mu"].items()},
            "nu": {k: full(v) for k, v in opt["nu"].items()},
            "mu_placements": {k: tuple(v.placements) for k, v in opt["mu"].items()},
            "param_placements": {k: tuple(p.placements) for k, p in params.named_parameters()}}


def scenario_cell(mesh_dm, in_dir):
    """``build_cell``'s training step on real DTensors: two microbatches,
    then AdamW (the cell's default), from the placements the cell gives."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params
    from repro_torch.train import init_opt_state

    inputs = torch.load(os.path.join(in_dir, "step_short.pt"))
    cfg = wide_config()
    seq, gb = inputs["batch"]["tokens"].shape[1], inputs["batch"]["tokens"].shape[0]
    cell = build_cell(cfg, ShapeConfig("train_short", "train", seq, gb), mesh_dm, n_micro=2)
    params = Model(cfg, device="cpu").init(0)
    params.load_state_dict(inputs["params"])
    shard_params(params, mesh_dm)
    p_shard, o_shard, b_shard = cell.in_shardings
    opt = init_opt_state(dict(params.named_parameters()))
    batch = {k: distribute_tensor(v, mesh_dm, b_shard[k], src_data_rank=None)
             for k, v in inputs["batch"].items()}
    placed = ({k: tuple(p.placements) for k, p in params.named_parameters()} == p_shard
              and {k: tuple(v.placements) for k, v in opt["mu"].items()} == o_shard["mu"])
    params, opt, loss, gnorm = cell.step_fn(params, opt, batch)
    return {"loss": float(loss), "grad_norm": float(gnorm), "placed": placed,
            "loss_after": loss_at(Model(cfg, device="cpu"), params, batch),
            "params": {k: full(p) for k, p in params.named_parameters()}}


def tanh_stack(seed=0, L=8, d=16, B=16, S=4):
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.normal(size=(L, d, d)) * 0.1 + np.eye(d), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(B, S, d)), dtype=torch.float32)
    return w, x


def tanh_stage(p, x):
    for wl in p["w"]:
        x = torch.tanh(x @ wl)
    return x


class BlockCall(torch.nn.Module):
    """One decoder block of the reduced model as a module with a forward
    (``torch.func.functional_call`` runs it on a layer's slice)."""

    def __init__(self, cfg, block):
        super().__init__()
        self.cfg, self.block = cfg, block

    def forward(self, x):
        from repro_torch.models.transformer import _decoder_block

        b, s, _ = x.shape
        pos = torch.arange(s)[None, :].expand(b, s)
        return _decoder_block(self.cfg, self.block, x, positions=pos, cache=None, length=0,
                              use_chunked=False)[0]


def qwen_blocks(seed=0):
    """(the reduced model's 4 blocks, their BlockCall, x)."""
    from repro_torch.models.transformer import Model

    cfg = wide_config(n_layers=4)
    params = Model(cfg, device="cpu").init(seed)
    x = torch.tensor(np.random.default_rng(seed + 1).normal(size=(8, 16, cfg.d_model)),
                     dtype=torch.float32)
    return params.blocks, BlockCall(cfg, params.blocks[0]), x


def block_stage(call):
    def stage(p, x):
        for i in range(next(iter(p.values())).shape[0]):
            x = torch.func.functional_call(call, {f"block.{k}": v[i] for k, v in p.items()}, (x,))
        return x
    return stage


def pipeline_case(mesh_pd, stage_fn, stacked, x, n_micro):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime import pipeline_apply, pipeline_spec_for, placements

    specs = pipeline_spec_for(stacked)
    leaves = {k: torch.nn.Parameter(distribute_tensor(
        v.detach(), mesh_pd, placements(specs[k], mesh_pd), src_data_rank=None))
        for k, v in stacked.items()}
    xd = distribute_tensor(x, mesh_pd, placements(("data",), mesh_pd), src_data_rank=None)
    xd.requires_grad_(True)
    out = pipeline_apply(stage_fn, leaves, xd, mesh=mesh_pd, n_micro=n_micro)
    out.sum().backward()
    return {"out": full(out), "x_grad": full(xd.grad),
            "p_grads": {k: full(v.grad) for k, v in leaves.items()},
            "out_placements": tuple(out.placements)}


def scenario_pipeline(mesh_pd):
    from repro_torch.runtime import stack_stage_params

    w, x = tanh_stack()
    out = {f"tanh_{n}": pipeline_case(mesh_pd, tanh_stage,
                                      stack_stage_params({"w": w}, 2), x, n)
           for n in (1, 2, 4)}
    blocks, call, xq = qwen_blocks()
    out["qwen_2"] = pipeline_case(mesh_pd, block_stage(call),
                                  stack_stage_params(blocks, 2), xq, 2)
    return out


def scenario_multipod_sum(mesh_3d):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime import placements

    x = torch.arange(16.0).reshape(8, 2)
    pl = placements((("pod", "data"), "model"), mesh_3d)
    xs = distribute_tensor(x, mesh_3d, pl, src_data_rank=None)
    return {"total": float(xs.sum().full_tensor()), "want": float(x.sum()),
            "placements": tuple(xs.placements), "local": tuple(xs.to_local().shape)}


def scenario_checkpoint(mesh_a, mesh_b, out_dir):
    """Save from (data 2, model 4); restore onto (data 4, model 2)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import param_shardings, shard_params

    params = Model(wide_config(), device="cpu").init(0)
    original = {k: p.detach().clone() for k, p in params.named_parameters()}
    shard_params(params, mesh_a)
    store = CheckpointStore(os.path.join(out_dir, "ckpt"))
    store.save(1, {k: p.detach() for k, p in params.named_parameters()})
    target = param_shardings(params, mesh_b)
    restored, _ = store.restore(1, original, shardings=target, mesh=mesh_b)
    return {"equal": all(torch.equal(full(restored[k]), original[k]) for k in original),
            "placed": all(tuple(restored[k].placements) == target[k]
                          and restored[k].device_mesh is mesh_b for k in original),
            "original": original}


def rank_main(rank, world, out_dir, in_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdv')}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh, make_mesh

        mesh_dm = make_local_mesh(data=2, model=4, device="cpu")
        results = {"place": scenario_place(mesh_dm)}
        for tag in ("short", "long", "fsdp"):
            results[f"step_{tag}"] = scenario_step(mesh_dm, in_dir, tag)
        results["cell"] = scenario_cell(mesh_dm, in_dir)
        results["pipeline"] = scenario_pipeline(make_mesh((2, 4), ("pod", "data"), device="cpu"))
        results["sum"] = scenario_multipod_sum(
            make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu"))
        results["ckpt"] = scenario_checkpoint(
            mesh_dm, make_local_mesh(data=4, model=2, device="cpu"), out_dir)
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    in_dir, out_dir = sys.argv[1], sys.argv[2]
    world = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    mp.spawn(rank_main, args=(world, out_dir, in_dir), nprocs=world, join=True)
