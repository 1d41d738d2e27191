"""Training loop: one step with microbatch accumulation and compression.

The JAX package's ``train/trainer.py``, eager.  ``make_train_step`` builds

    step(params, opt_state, comp_state, batch, rng) -> (params, opt_state, comp_state, metrics)

where ``params`` is the model's ``nn.Module``.  The step:

* **Gradients** by ``torch.autograd.grad`` of ``loss_fn(params, batch)``;
  with ``n_micro > 1`` the batch is split along its first dim and each
  microbatch's gradients are added into float32 accumulators divided by
  ``n_micro`` (the loss likewise), as the JAX package's scan does; with
  one microbatch they are cast to float32.
* **Compression** (optional) of the float32 gradients before the
  optimizer: top-k with error feedback, or int8 stochastic rounding drawn
  from ``rng``, a ``torch.Generator`` on the parameters' device; the unit
  is the JAX package's leaf (``convert.jax_leaf_groups``).
* **AdamW** (``train.optimizer.adamw_update``) writes the parameters and
  moments in place under ``torch.no_grad()``: the counterpart of the JAX
  step's buffer donation.  Weight decay follows the JAX leaf's rank
  (``convert.weight_decay_mask``).

Metrics stay on the device (``loss``, ``lr``, ``grad_norm``) until
``train_loop`` reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.runtime import compression as comp_lib
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step", "train_loop"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    n_micro: int = 1
    compression: str = "none"          # "none" | "topk" | "int8"
    topk_frac: float = 0.01


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: OptState
    comp_state: comp_lib.CompressionState | None


def _trainable(params: nn.Module) -> dict:
    return {k: p for k, p in params.named_parameters() if p.requires_grad}


def init_train_state(params: nn.Module, cfg: TrainConfig) -> TrainState:
    leaves = _trainable(params)
    comp = comp_lib.init_compression_state(leaves) if cfg.compression == "topk" else None
    return TrainState(params=params, opt_state=init_opt_state(leaves), comp_state=comp)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements: autograd leaves
    the sum over the batch's shards pending (``Partial``); this reduces it
    (a reduce-scatter onto a sharded parameter, an all-reduce onto a
    replicated one)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _float_grads(loss: torch.Tensor, tensors: list):
    """The float32 gradients of ``loss`` for ``tensors``, one at a time, each
    in its parameter's placements (:func:`_placed_like`); autograd's own
    gradient is dropped as soon as its float32 copy exists, so a rank never
    holds every unreduced gradient beside every reduced one."""
    grads = list(torch.autograd.grad(loss, tensors))
    for i, p in enumerate(tensors):
        g, grads[i] = grads[i], None
        yield _placed_like(g, p).to(torch.float32)


def _split(batch: dict, n: int, i: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}


def make_train_step(
    loss_fn: Callable[[nn.Module, dict], tuple[torch.Tensor, dict]],
    cfg: TrainConfig,
):
    """Returns ``step(params, opt_state, comp_state, batch, rng)``."""

    def accumulate(params: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
        leaves = _trainable(params)
        names, tensors = list(leaves), list(leaves.values())
        if cfg.n_micro == 1:
            loss, _ = loss_fn(params, batch)
            return loss.detach(), {k: g for k, g in zip(names, _float_grads(loss, tensors))}
        if any(v.shape[0] % cfg.n_micro for v in batch.values()):
            raise ValueError(f"the batch does not split into {cfg.n_micro} microbatches")
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        for i in range(cfg.n_micro):
            loss, _ = loss_fn(params, _split(batch, cfg.n_micro, i))
            for k, g in zip(names, _float_grads(loss, tensors)):
                acc[k] = acc[k] + g / cfg.n_micro
            loss_acc = loss_acc + loss.detach() / cfg.n_micro
        return loss_acc, acc

    def step(params: nn.Module, opt_state: OptState, comp_state, batch: dict,
             rng: torch.Generator | None):
        loss, grads = accumulate(params, batch)
        if cfg.compression == "topk":
            grads, comp_state = comp_lib.topk_compress_with_ef(
                grads, comp_state, frac=cfg.topk_frac)
        elif cfg.compression == "int8":
            q8, scales = comp_lib.int8_compress(grads, rng)
            grads = comp_lib.int8_decompress(q8, scales)
        _, opt_state, om = adamw_update(cfg.optimizer, _trainable(params), grads, opt_state)
        return params, opt_state, comp_state, {"loss": loss, **om}

    return step


def train_loop(
    model_loss_fn: Callable[[nn.Module, dict], tuple[torch.Tensor, dict]],
    params: nn.Module,
    batches,                    # iterable of batch dicts
    cfg: TrainConfig,
    *,
    hooks: list[Callable[[int, dict], None]] | None = None,
) -> tuple[TrainState, list[dict]]:
    """Drive ``make_train_step`` over an iterable of batches; ``params`` are
    updated in place.  Returns the state and each step's metrics as
    floats.  The int8 compression's draws come from a generator seeded 0
    on the parameters' device."""
    state = init_train_state(params, cfg)
    step_fn = make_train_step(model_loss_fn, cfg)
    device = next(params.parameters()).device
    rng = torch.Generator(device=device).manual_seed(0)
    history: list[dict] = []
    for i, batch in enumerate(batches):
        state.params, state.opt_state, state.comp_state, metrics = step_fn(
            state.params, state.opt_state, state.comp_state, batch, rng)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        for h in hooks or []:
            h(i, metrics)
    return state, history
