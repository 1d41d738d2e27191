"""Reference training steps in float32: the family's plain forward, the
mean token NLL over a batch, AdamW with global-norm clipping, and the
learning-rate schedule the traffic file states, all on the float32 widening
of the weights the benchmark drew.

AdamW, step ``t`` from 1: clip the gradient to the global norm
``grad_clip``; ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``;
``p -= lr_t (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)``, the
decay on every leaf of two or more dimensions and on every per-layer leaf
(a name with a layer index), as the port's optimizer decays the JAX
package's stacked leaves.  ``lr_t = lr * min(1, (t + 1) / warmup) * (f +
(1 - f) (1 + cos(pi * clip((t - warmup) / (total - warmup), 0, 1))) / 2)``
with ``f = min_lr_frac``: the port's schedule as its docstring states it.

A batch is taken row by row, each row's gradient added in, so that the
activations of one row at a time are alive; each layer is recomputed in
the backward.  The result is the same sum."""

from __future__ import annotations

import math
import re

import torch

from bench.reference.common import Weights, cross_entropy, logits_at, plain_f32


def decays(name: str, t: torch.Tensor) -> bool:
    return t.ndim >= 2 or re.search(r"\.\d+\.", name) is not None


def learning_rate(opt: dict, t: int) -> float:
    warm = min(1.0, (t + 1) / max(opt["warmup_steps"], 1))
    prog = min(max((t - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def train_steps(family, weights: dict, m: dict, batches: list, opt: dict, *,
                precision: str = "f32") -> dict:
    """Follow ``len(batches)`` steps from ``weights`` (``{name: tensor}``).
    ``batches``: ``(tokens, labels)`` pairs of (B, S).  Returns the first
    step's clipped gradient (the gradient as the optimizer applies it) and
    the per-leaf norms of the parameters' change after the last step."""
    params = {n: t.detach().to(torch.float32).clone().requires_grad_(True)
              for n, t in weights.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    w = Weights(params, precision)
    grad1 = None
    with plain_f32():
        for t, (tokens, labels) in enumerate(batches, start=1):
            for p in params.values():
                p.grad = None
            count = (labels != -100).sum()
            for r in range(tokens.shape[0]):
                h = family.hidden(w, tokens[r:r + 1], m, checkpoint=True)
                part = cross_entropy(logits_at(w, h, m), labels[r:r + 1]) * (
                    (labels[r] != -100).sum() / count)
                part.backward()
                del h, part
            with torch.no_grad():
                grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in params.items()}
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
                scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-12))
                if t == 1:
                    grad1 = {n: g * scale for n, g in grads.items()}
                lr = learning_rate(opt, t)
                b1c, b2c = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
                for n, p in params.items():
                    g = grads[n] * scale
                    mu[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    nu[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                    delta = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + opt["eps"])
                    if decays(n, p):
                        delta = delta + opt["weight_decay"] * p
                    p.sub_(lr * delta)
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - weights[n].to(torch.float32)))
                  for n, p in params.items()}
    return {"grad1": grad1, "change": change}
