"""build_cell(): the arguments and layouts of one (arch x shape x mesh) cell.

The JAX package's ``launch/specs.py``: for a training cell the arguments
are (params, opt_state, batch); for a prefill cell (params, batch, cache);
for a decode cell (params, tokens, cache, extras).  Every argument is a
tensor on the ``meta`` device (shapes and dtypes only, nothing allocated:
the counterpart of ``jax.eval_shape``), the parameters an ``nn.Module``
of them.  ``in_shardings``/``out_shardings`` are the same trees with DTensor
placements (``runtime.sharding``) where JAX has ``NamedSharding``\\ s,
leaf for leaf the reference's.

``step_fn`` runs on real DTensors (the arguments placed by
``in_shardings``) for every cell of every family.  The training step
accumulates gradients over ``n_micro`` microbatches, then runs AdamW, as
the JAX cell.  The serving steps are ``Model.prefill`` and
``Model.decode_step``: they return ``(logits, cache)`` placed as
``out_shardings`` says, the cache written in place (the counterpart of
``donate_argnums=(2,)``; ``length`` stays a host integer).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch_shapes
from repro_torch.models.transformer import Model, build_model
from repro_torch.runtime import sharding as shard_lib

__all__ = ["CellSpec", "build_cell"]


@dataclasses.dataclass
class CellSpec:
    """Everything a sharded run or the dry run needs for one cell."""

    model: Model
    kind: str                  # "train" | "prefill" | "decode"
    arg_shapes: tuple          # positional "meta" arguments of step_fn
    in_shardings: tuple
    out_shardings: Any
    step_fn: Any               # callable(*args)
    donate_argnums: tuple


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_shapes(params) -> dict:
    f32 = {k: _meta(p.shape, torch.float32) for k, p in params.named_parameters()}
    return {"mu": f32, "nu": dict(f32), "step": _meta((), torch.int32)}


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    n_micro: int = 1,
    remat: bool = True,
    fsdp: bool | str = True,
    vocab_chunk: int = 0,
    cache_prefer: str = "largest",
    expert_mode: str = "ep_model",
) -> CellSpec:
    """The cell of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
    stand-in with ``mesh_dim_names`` and ``shape``).  ``fsdp``: True
    (parameters and moments 2-D), False (TP only), or ``"zero1"``
    (parameters TP only, moments 2-D: the gradients reduce-scatter to the
    moments' layout)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, make_train_step

    model = build_model(cfg, device="meta")
    model.remat = remat
    model.vocab_chunk = vocab_chunk
    params = model.init()
    p_shard = shard_lib.param_shardings(params, mesh, fsdp=fsdp is True,
                                        expert_mode=expert_mode)
    repl = shard_lib.placements((), mesh)

    if shape.kind == "train":
        batch_shapes = make_batch_shapes(cfg, shape.seq_len, shape.global_batch)
        b_shard = shard_lib.input_shardings(batch_shapes, mesh)
        o_shapes = _opt_shapes(params)
        o_fsdp = fsdp in (True, "zero1")
        moments = shard_lib.param_shardings(params, mesh, fsdp=o_fsdp, expert_mode=expert_mode)
        o_shard = {"mu": moments, "nu": dict(moments), "step": repl}
        step = make_train_step(model.train_loss,
                               TrainConfig(optimizer=AdamWConfig(), n_micro=n_micro))

        def train_step(params, opt_state, batch):
            params, opt_state, _, m = step(params, opt_state, None, batch, None)
            return params, opt_state, m["loss"], m["grad_norm"]
        return CellSpec(
            model=model, kind="train",
            arg_shapes=(params, o_shapes, batch_shapes),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, repl, repl),
            step_fn=train_step, donate_argnums=(0, 1))

    # ---------------- serving cells -----------------------------------
    bsz = shape.global_batch
    logits = shard_lib.input_shardings(_meta((bsz, cfg.vocab_size), torch.float32), mesh)
    cache_shapes = model.init_cache(bsz, shape.seq_len)
    c_shard = shard_lib.state_shardings(cache_shapes, mesh, batch_size=bsz, prefer=cache_prefer)
    if shape.kind == "prefill":
        batch_shapes = make_batch_shapes(cfg, shape.seq_len, bsz)
        batch_shapes.pop("labels")

        def prefill_step(params, batch, cache):
            logits, cache = model.prefill(params, batch, cache)
            return logits, cache

        return CellSpec(
            model=model, kind="prefill",
            arg_shapes=(params, batch_shapes, cache_shapes),
            in_shardings=(p_shard, shard_lib.input_shardings(batch_shapes, mesh), c_shard),
            out_shardings=(logits, c_shard),
            step_fn=prefill_step, donate_argnums=(2,))

    # decode: one new token against a cache of seq_len
    tok_shapes = _meta((bsz, 1), torch.int64)
    extras = {}
    if cfg.rope_variant == "mrope":
        extras["positions"] = _meta((bsz, 1, 3), torch.int64)

    def decode_step(params, tokens, cache, extras):
        logits, cache = model.decode_step(params, tokens, cache, extras)
        return logits, cache

    return CellSpec(
        model=model, kind="decode",
        arg_shapes=(params, tok_shapes, cache_shapes, extras),
        in_shardings=(p_shard, shard_lib.input_shardings(tok_shapes, mesh), c_shard,
                      shard_lib.input_shardings(extras, mesh)),
        out_shardings=(logits, c_shard),
        step_fn=decode_step, donate_argnums=(2,))
