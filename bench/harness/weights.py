"""Weights drawn from the seed on the device, by the laws of the config file.

The program's parameters are listed by name, shape and dtype (its module
built on ``meta``: shapes only); the benchmark draws every parameter of one
dtype from ONE ``torch.Generator`` call into one flat buffer, and each
parameter is a view of that buffer with its law applied in place.  The
same seed on the same device gives the same values, so the reference is
handed the same weights by drawing them again after the program's state
is freed.

A law is ``[regex, name, *args]`` in the config's ``init`` list; the first
regex that matches a parameter's name (``re.search``) gives its law:

* ``["normal", std]``: N(0, std^2);
* ``["normal_fan_in"]``: N(0, 1 / shape[0]) (a ``(d_in, d_out)`` matrix);
* ``["one_plus_normal", std]``: 1 + N(0, std^2);
* ``["log_linspace_plus_normal", lo, hi, std]``: log of ``linspace(lo, hi,
  n)`` along the last axis, plus N(0, std^2).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

STREAMS = {"weights": 1, "data": 2, "requests": 3, "sample": 4}


def derived_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one of the run's streams, from ``--seed``."""
    state = np.random.SeedSequence([seed % 2**64, STREAMS[stream]]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def param_specs(module: torch.nn.Module) -> list[tuple[str, tuple, torch.dtype]]:
    """``(name, shape, dtype)`` of every parameter, in the module's order."""
    return [(n, tuple(p.shape), p.dtype) for n, p in module.named_parameters()]


def _law(laws: list, name: str) -> list:
    for rule in laws:
        if re.search(rule[0], name):
            return rule[1:]
    raise KeyError(f"no init law in the config matches parameter {name!r}")


def _apply(view: torch.Tensor, law: list) -> None:
    kind, args = law[0], law[1:]
    if kind == "normal":
        view.mul_(args[0])
    elif kind == "normal_fan_in":
        view.mul_(1.0 / math.sqrt(view.shape[0]))
    elif kind == "one_plus_normal":
        view.mul_(args[0]).add_(1.0)
    elif kind == "log_linspace_plus_normal":
        lo, hi, std = args
        base = torch.log(torch.linspace(lo, hi, view.shape[-1], dtype=torch.float32,
                                        device=view.device))
        view.mul_(std).add_(base.to(view.dtype))
    else:
        raise ValueError(f"unknown init law {kind!r}")


def draw(specs, laws: list, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs``: one flat buffer per dtype, filled by
    one ``normal_`` call of a generator seeded from ``seed``, each tensor a
    view of it with its law applied."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "weights"))
    out = {}
    for dtype in sorted({d for _, _, d in specs}, key=str):
        group = [(n, s) for n, s, d in specs if d == dtype]
        flat = torch.empty(sum(math.prod(s) for _, s in group), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        off = 0
        for name, shape in group:
            n = math.prod(shape)
            view = flat[off:off + n].view(shape)
            _apply(view, _law(laws, name))
            out[name] = view
            off += n
    return {n: out[n] for n, _, _ in specs}


def install(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Make each parameter of ``module`` (built on ``meta``) the tensor of
    its name, keeping whether it is trained."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = torch.nn.Parameter(weights[name], requires_grad=p.requires_grad)
