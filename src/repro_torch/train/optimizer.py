"""AdamW with a warmup-cosine schedule and global-norm clipping.

The JAX package's ``train/optimizer.py`` on dicts of tensors: a parameter
tree is ``{name: tensor}`` (a model's ``named_parameters()``), and the
optimizer state ``{"mu": {name: f32}, "nu": {name: f32}, "step": int32
scalar}`` mirrors it leaf for leaf.  The moments and every step of the
update are float32 whatever the parameter's dtype; the new parameter is
rounded back to it.  :func:`adamw_update` writes the parameters and the
moments in place (the counterpart of the JAX step's buffer donation) and
returns them.

Decoupled weight decay applies to the leaves the JAX package decays:
those whose array has two or more dimensions.  The JAX package stacks
per-layer leaves along leading axes, so it also decays, for instance, the
stacked per-layer norm scales, biases and Mamba2 ``a_log``/``d_skip``/
``dt_bias``, which the port holds per layer as 1-D tensors: the update
takes the decision from the parameter's name, through
``convert.weight_decay_mask``, which answers from the rank of the JAX leaf
each parameter came from.  A name the JAX package does not stack keeps the
tensor's own rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

from repro_torch.convert import weight_decay_mask

__all__ = [
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# {"mu": {name: f32}, "nu": {name: f32}, "step": int32 scalar}
OptState = dict


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero moments in float32 beside each parameter, step 0.  A DTensor
    parameter's moments are DTensors of its placements (as the JAX
    package's moments inherit the parameter's sharding)."""
    f32 = torch.float32
    some = next(iter(params.values()), None)
    device = some.device if some is not None else "cpu"
    return {
        "mu": {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup over ``warmup_steps``, then a cosine from ``lr`` down
    to ``min_lr_frac`` of it at ``total_steps``; float32 on the step's
    device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
        return cfg.lr * warm * frac

    return lr


def clip_by_global_norm(grads: Mapping[str, torch.Tensor],
                        max_norm: float) -> tuple[dict, torch.Tensor]:
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    the norm is float32 over every leaf (of DTensor leaves: over every
    element of every shard, a replicated DTensor)."""
    leaves = list(grads.values())
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device if leaves else "cpu")
    sq = sum((torch.sum(torch.square(g.to(torch.float32))) for g in leaves), zero)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: OptState,
) -> tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """One AdamW step: clip, then update every parameter and both moments
    in place, weight decay on the leaves ``convert.weight_decay_mask``
    names.  Returns ``(params, state, {"lr", "grad_norm"})``."""
    decay = weight_decay_mask(params)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for name, p in params.items():
        g = grads[name].to(torch.float32)
        mu = cfg.b1 * state["mu"][name] + (1 - cfg.b1) * g
        nu = cfg.b2 * state["nu"][name] + (1 - cfg.b2) * g * g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if decay[name]:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        state["mu"][name].copy_(mu)
        state["nu"][name].copy_(nu)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
