"""One gloo world of CPU ranks for ``test_torch_sharded_serving.py``.

    python tests/_torch_dist_serving.py IN_DIR OUT_DIR [WORLD]

Spawns ``WORLD`` (8) ranks over a ``file://`` rendezvous in ``OUT_DIR``, on
a (data 2, model 4) mesh.  ``IN_DIR/cases.pt`` holds the cases, ``{name:
{"arch", "widths", "expert_mode", "cache_prefer", "params", "max_len",
"batch" or "cache", "extras", "steps", "count_comms"}}``.  Each rank runs ``launch.specs.
build_cell``'s serving steps on every case, every argument placed as the
cells' ``in_shardings`` say: a case with a ``"batch"`` (the prompt) runs
the prefill cell's step into its ``"cache"`` (whole tensors and its
``length``) or an empty one, one with a ``"cache"`` alone starts from that
cache; then ``steps`` greedy
steps of the decode cell (with ``count_comms``, each step under the
collective counter of ``repro_torch.obs.collectives``, the dry run's: a
dispatch mode slows every op).  Rank 0
writes each result (the logits and greedy tokens of every step, every cache
leaf as a full tensor after the prefill and after the last step, the
leaves' placements against the cells' ``out_shardings``, the collectives
of each decode step) to ``OUT_DIR/results.pt``.  A case that raises
records its traceback instead.  Imports neither ``jax`` nor ``repro``.
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


def flat(tree, prefix=""):
    """A nested cache dict as ``{"a/b": leaf}``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def full(t):
    return t.full_tensor().detach().clone() if hasattr(t, "full_tensor") else t


def place_tree(tree, shardings, mesh):
    """Every tensor of ``tree`` placed by ``shardings`` (the same tree of
    placements); a host integer stays as it is."""
    from repro_torch.runtime.sharding import place

    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k], mesh) for k, v in tree.items()}
    return place(tree, mesh, shardings) if isinstance(tree, torch.Tensor) else tree


def placements_of(tree):
    if isinstance(tree, dict):
        return {k: placements_of(v) for k, v in tree.items()}
    return tuple(tree.placements) if hasattr(tree, "placements") else None


def same_layout(got, want) -> bool:
    """Each tensor leaf of ``got`` in ``want``'s placements (a host integer
    has none)."""
    g, w = flat(placements_of(got)), flat(want)
    return set(g) == set(w) and all(g[k] is None or g[k] == w[k] for k in g)


def run_case(mesh, case: dict) -> dict:
    """The case's serving cells on the mesh (module docstring)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import shard_params

    cfg = case_config(case)
    mode = case.get("expert_mode", "ep_model")
    prefer = case.get("cache_prefer", "largest")
    max_len = case["max_len"]
    bsz = (case["batch"]["tokens"] if "batch" in case else case["tokens"]).shape[0]
    decode = build_cell(cfg, ShapeConfig("decode_case", "decode", max_len, bsz), mesh,
                        expert_mode=mode, cache_prefer=prefer)
    params = Model(cfg, device="cpu").init(0)
    params.load_state_dict(case["params"])
    shard_params(params, mesh, expert_mode=mode)
    p_shard, t_shard, c_shard, e_shard = decode.in_shardings
    out = {"placed": {k: tuple(p.placements) for k, p in params.named_parameters()} == p_shard,
           "logits": [], "tokens": [], "collectives": [], "layout_ok": [],
           "cache_placements": flat(c_shard)}
    if "batch" in case:
        cell = build_cell(cfg, ShapeConfig("prefill_case", "prefill", max_len, bsz), mesh,
                          expert_mode=mode, cache_prefer=prefer)
        _, b_shard, pc_shard = cell.in_shardings
        batch = place_tree(case["batch"], b_shard, mesh)
        cache = place_tree(case["cache"] if "cache" in case
                           else Model(cfg, device="cpu").init_cache(bsz, max_len), pc_shard, mesh)
        logits, cache = cell.step_fn(params, batch, cache)
        out["prefill_layout_ok"] = (same_layout(cache, cell.out_shardings[1])
                                    and tuple(logits.placements) == cell.out_shardings[0])
        out["prefill_cache"] = {k: full(v) for k, v in flat(cache).items()}
        tokens = full(logits).argmax(-1, keepdim=True)
        out["logits"].append(full(logits))
    else:
        cache = place_tree(case["cache"], c_shard, mesh)
        tokens = case["tokens"]
    for step in range(case["steps"]):
        out["tokens"].append(tokens.clone())
        tok = place_tree(tokens, t_shard, mesh)
        extras = place_tree(case["extras"][step], e_shard, mesh)
        if case.get("count_comms"):
            from repro_torch.obs.collectives import CollectiveCount

            with CollectiveCount() as comm:
                logits, cache = decode.step_fn(params, tok, cache, extras)
            out["collectives"].append({"by_kind": comm.summary(),
                                       "bytes": sum(comm.bytes.values())})
        else:
            logits, cache = decode.step_fn(params, tok, cache, extras)
        whole = full(logits)
        out["layout_ok"].append(same_layout(cache, decode.out_shardings[1])
                                and tuple(logits.placements) == decode.out_shardings[0])
        out["logits"].append(whole)
        tokens = whole.argmax(-1, keepdim=True)
    out["cache"] = {k: full(v) for k, v in flat(cache).items()}
    return out


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
                results[name] = run_case(mesh, case)
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
