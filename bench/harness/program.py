"""What the benchmark takes from the program (``repro_torch``): its model
for a config file, its launch counters, and nothing else.  The drivers
take its training step and serving engine themselves."""

from __future__ import annotations

import dataclasses
import importlib

import torch

from bench.harness import weights as weights_lib
from bench.harness.cell import load_module


def port_config(config: dict):
    """The port's ``ModelConfig`` of a config file: the registry's entry for
    ``port_arch`` with every size of ``model`` that it has set to the
    file's value (the file is what runs)."""
    from repro_torch.configs import get_config

    base = get_config(config["port_arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in config["model"].items()
                                        if k in fields})


def build(config: dict, seed: int, device):
    """``(cfg, model, params, specs)``: the port's model on ``device`` with
    parameters drawn by the benchmark from ``seed`` (the module built on
    ``meta``, each parameter then a view of the benchmark's buffers)."""
    from repro_torch.models.transformer import Model

    cfg = port_config(config)
    params = Model(cfg, device="meta").init()
    specs = weights_lib.param_specs(params)
    weights_lib.install(params, weights_lib.draw(specs, config["init"], seed, device))
    return cfg, Model(cfg, device=device), params, specs


def _counter(kernel: str):
    module, table, key = load_module("kernels", kernel).COUNTER
    return getattr(importlib.import_module(module), table), key


def reset_counters(kernels) -> None:
    for k in kernels:
        table, key = _counter(k)
        table[key] = 0


def read_counters(kernels) -> dict:
    out = {}
    for k in kernels:
        table, key = _counter(k)
        out[k] = table[key]
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
