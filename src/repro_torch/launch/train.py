"""End-to-end training driver.

    python -m repro_torch.launch.train --arch zamba2-1.2b --seq-len 8192 --global-batch 2
    python -m repro_torch.launch.train --arch qwen2-7b --reduced --device cpu --steps 5

The JAX package's ``launch/train.py`` with the same flags, on one device
(``--device``, default the GPU; without one this raises ``KernelError``):
config -> the paper's MCOP placement report for the training stage graph
(``repro_torch.core.placement``) -> model from ``--seed`` (random weights)
-> the synthetic data stream -> the train step -> checkpoints.  With
``--ckpt-dir`` a run resumes from the directory's latest checkpoint (the
parameters and the optimizer state), saves every ``--ckpt-every`` steps in
the background and once more at the end.  ``--reduced`` swaps in the
family's smoke-scale config.  Each log line carries the loss, learning
rate, gradient norm and tokens a second.

A run is deterministic: ``run`` turns on
``torch.use_deterministic_algorithms(True)`` for its duration (PyTorch's
backward of the embedding lookup, an indexed add, otherwise adds in no
fixed order on the GPU; the port's kernels are deterministic by design),
so a run resumed from a checkpoint repeats the uninterrupted run's steps
bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compression", default="none", choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train_tree(state) -> dict:
    """The checkpointed part of a ``TrainState``: the parameters and the
    optimizer state, by name."""
    return {"params": state.params.state_dict(), "opt": state.opt_state}


def run(argv=None, *, hooks=None) -> dict:
    """Parse ``argv`` and train with deterministic algorithms on (restored
    on return); returns ``{"start": the resumed step, "history": [each
    step's metrics as floats, with its seconds]}``.  ``hooks`` are called
    after every step with ``(step, metrics)``."""
    args = parse_args(argv)

    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    # cuBLAS's documented setting for reproducible products (a caller's own wins)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, hooks)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _train(args: argparse.Namespace, hooks) -> dict:
    import torch

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.placement import TPUV5E_TIER, plan_placement
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels.mcop_phase import require_device
    from repro_torch.models.transformer import build_model
    from repro_torch.profilers.program import stage_specs
    from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step

    device = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)

    # --- MCOP placement report (the paper's pass, on this model) --------
    shape = ShapeConfig("cli", "train", args.seq_len, args.global_batch)
    plan = plan_placement(
        stage_specs(cfg, shape, group=max(cfg.n_layers // 8, 1)),
        dataclasses.replace(TPUV5E_TIER, name="local", chips=128),
        dataclasses.replace(TPUV5E_TIER, name="remote", chips=128),
    )
    print(f"[train] MCOP placement: cut={plan.mcop_cost:.3e}s "
          f"boundary={plan.contiguous_boundary} cut_bytes={plan.cut_bytes:.3e}", flush=True)

    model = build_model(cfg, device=device)
    params = model.init(args.seed)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {device}", flush=True)

    data = SyntheticLMDataset(
        DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                   vocab_size=cfg.vocab_size, seed=args.seed),
        cfg, device=device)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                              total_steps=args.steps),
        n_micro=args.n_micro,
        compression=args.compression,
    )
    state = init_train_state(params, tcfg)
    step_fn = make_train_step(model.train_loss, tcfg)

    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if store and store.latest_step() is not None:
        start, tree, _ = store.restore_latest(train_tree(state))
        with torch.no_grad():
            params.load_state_dict(tree["params"])
        state.opt_state = tree["opt"]
        print(f"[train] resumed from step {start}", flush=True)

    rng = torch.Generator(device=device).manual_seed(args.seed + 1)
    tokens = args.seq_len * args.global_batch
    t0 = time.perf_counter()
    history = []
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = data.batch(step)
        state.params, state.opt_state, state.comp_state, m = step_fn(
            state.params, state.opt_state, state.comp_state, batch, rng)
        metrics = {k: float(v) for k, v in m.items()}  # reads the step's end on the device
        metrics["seconds"] = time.perf_counter() - t_step
        history.append(metrics)
        for h in hooks or []:
            h(step, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = (step - start + 1) * tokens / max(time.perf_counter() - t0, 1e-9)
            print(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} gnorm {metrics['grad_norm']:.2f} "
                  f"tok/s {tok_s:,.0f}", flush=True)
        if store and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            store.save_async(step + 1, train_tree(state), extra={"arch": cfg.name})
    if store:
        store.wait()
        if not (history and args.ckpt_every and args.steps % args.ckpt_every == 0):
            store.save(args.steps, train_tree(state), extra={"arch": cfg.name})
    losses = [h["loss"] for h in history]
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({np.mean(losses[:5]):.3f}->{np.mean(losses[-5:]):.3f} smoothed)", flush=True)
    return {"start": start, "history": history}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
