"""MCOP-driven pipeline execution over the ``pod`` mesh axis.

The placement mapper (``core.placement``) turns an MCOP partition of the
layer graph into a *contiguous* stage split; this module runs that split
as a GPipe-style pipeline, the JAX package's ``shard_map`` body written on
each rank's local tensors:

* stage parameters are stacked on a leading ``n_stages`` axis and sharded
  ``Shard(0)`` over ``"pod"`` — each pod holds exactly its stage's weights;
* activations hop pods with one point-to-point shift a slot (the cut edge
  of the WCG — the paper's ``E_cut`` — becomes one transfer per
  microbatch per boundary);
* the schedule is the classic ``n_micro + n_stages − 1`` slot ramp: stage
  0 takes microbatch ``t`` at slot ``t``, stage ``i`` the output stage
  ``i − 1`` sent it at slot ``t − 1``;
* outputs are real on the last pod only and reach every pod by a masked
  all-reduce over ``"pod"``.

The JAX package runs one SPMD program: every pod computes every slot and
masks the invalid ones.  Here each rank knows its pod, so a slot outside
``0 <= t − pod < n_micro`` computes nothing and sends zeros; every rank
still joins every hop, valid slot or not.  The hop and the all-reduce are
``torch.autograd.Function``\\ s: the hop's backward is the reverse hop (a
gradient goes back one pod), the all-reduce's (``models.common.SumAcross``)
the identity (each rank holds the whole output's gradient).  Autograd on one rank does
not see another rank's use of a tensor, so the slots are tied into one
chain on every rank (each hop's input and the output take a zero-weighted
term of the previous hop's output): every rank then runs every hop's
backward, last slot first, and the collectives pair up.  A loss through
:func:`pipeline_apply` has the gradient of the sequential stack.

The hop is ``all_to_all_single`` with split sizes (each rank sends its
slot's activations to the next pod and receives the previous pod's): the
collective that NCCL, gloo on CPU tensors and the threaded test group all
carry, with no bytes sent past the last pod.  The process group is the
mesh's; this module never makes one.

The paper's cost model maps 1:1: per-microbatch stage time = node weight
``w(v)`` of the merged stage vertex; the hop bytes = cut edge weight
``w(e)·B``; the pipeline bubble, ``(n_stages − 1) / (n_micro + n_stages −
1)`` of the slots, = the paper's "idle power while the cloud computes"
energy term (§4.3.2).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import SumAcross
from repro_torch.runtime.sharding import place

__all__ = ["stack_stage_params", "pipeline_apply", "pipeline_spec_for"]


def stack_stage_params(layer_params: Any, n_stages: int) -> dict:
    """(L, …) stacked per-layer params → (n_stages, L/n_stages, …).

    ``layer_params`` is ``{name: (L, …) tensor}``, or a list of ``L``
    modules of one structure (an ``nn.ModuleList`` of blocks), which
    ``torch.func.stack_module_state`` stacks first."""
    if isinstance(layer_params, (nn.ModuleList, list, tuple)):
        layer_params, _ = torch.func.stack_module_state(list(layer_params))
    out = {}
    for k, x in layer_params.items():
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{k}: {n} layers do not split into {n_stages} stages")
        out[k] = x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return out


def pipeline_spec_for(params_stacked: dict) -> dict:
    """The spec ``("pod",)`` — the stage axis over ``"pod"`` — for every
    stacked stage-param leaf."""
    return {k: ("pod",) for k in params_stacked}


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Each rank's ``t`` to the rank ``step`` further along ``group``; a
    rank with no sender gets zeros."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst, src = me + step, me - step
    t = t.contiguous()
    out = torch.zeros_like(t)
    numel = t.numel()
    send = t.reshape(-1) if 0 <= dst < n else t.reshape(-1)[:0]
    recv = out.reshape(-1) if 0 <= src < n else out.reshape(-1)[:0]
    dist.all_to_all_single(recv, send, [numel if r == src else 0 for r in range(n)],
                           [numel if r == dst else 0 for r in range(n)], group=group)
    return out


class _Hop(torch.autograd.Function):
    """Pod i → i+1; pod 0 receives zeros.  Backward: the reverse hop."""

    @staticmethod
    def forward(ctx, y, tie, group):
        ctx.group = group
        ctx.save_for_backward(tie)
        return _shift(y, group, +1)

    @staticmethod
    def backward(ctx, g):
        (tie,) = ctx.saved_tensors
        return _shift(g, ctx.group, -1), torch.zeros_like(tie), None


def pipeline_apply(
    stage_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    params_stacked: dict,          # {name: (n_stages, L/S, …)}
    x: torch.Tensor,               # (B, S, d) activations entering stage 0
    *,
    mesh,
    n_micro: int,
    axis: str = "pod",
) -> DTensor:
    """Run ``x`` through the staged blocks as a microbatched pipeline.

    ``stage_fn(stage_params, x_micro) -> y_micro`` runs one stage's layer
    group on plain local tensors (``stage_params``: ``{name: (L/S, …)}``)
    and keeps the activation's shape.  ``params_stacked`` holds DTensors
    (placed by :func:`pipeline_spec_for`) or full tensors that every rank
    holds alike, placed here.  ``x`` and the result keep the batch sharded
    over ``"data"`` (when the mesh has it) and are replicated over
    ``axis``; a plain ``x`` is the global batch, the same on every rank.
    Each rank's batch shard must split into ``n_micro`` microbatches."""
    names = tuple(mesh.mesh_dim_names)
    pod_dim = names.index(axis)
    n_stages = mesh.size(pod_dim)
    group = mesh.get_group(pod_dim)
    pod = mesh.get_local_rank(pod_dim)

    x_pl = tuple(Shard(0) if a == "data" else Replicate() for a in names)
    p_pl = tuple(Shard(0) if a == axis else Replicate() for a in names)
    # gradients: x reaches stage 0 only (the other pods' parts are zeros to
    # add); a stage's parameters serve every data shard (parts to add)
    x_grad = tuple(Partial() if a == axis else p for a, p in zip(names, x_pl))
    p_grad = tuple(Partial() if a == "data" else p for a, p in zip(names, p_pl))

    def placed(t, pl):
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
        return place(t, mesh, pl)

    keys = tuple(params_stacked)
    x = placed(x, x_pl)
    leaves = [placed(params_stacked[k], p_pl) for k in keys]

    def body(x_local, *stage):
        p_local = {k: t[0] for k, t in zip(keys, stage)}
        b = x_local.shape[0]
        if b % n_micro:
            raise ValueError(f"a rank's batch of {b} does not split into {n_micro} microbatches")
        micro = x_local.reshape(n_micro, b // n_micro, *x_local.shape[1:])
        # a 0-d zero that needs a gradient when anything does: it puts
        # every hop in the graph on every rank, and gives every input a
        # gradient (zeros where a rank does not use it)
        tie = sum((t.reshape(-1)[0] * 0 for t in (x_local, *stage) if t.requires_grad),
                  torch.zeros((), dtype=x_local.dtype, device=x_local.device))
        last = n_stages - 1
        in_buf = torch.zeros_like(micro[0])
        outs = []
        for t in range(n_micro + n_stages - 1):
            idx = t - pod
            if 0 <= idx < n_micro:
                y = stage_fn(p_local, micro[idx] if pod == 0 else in_buf)
                if pod == last:
                    outs.append(y)
            else:
                y = torch.zeros_like(micro[0])
            in_buf = _Hop.apply(y + in_buf * 0, tie, group)
        out = torch.stack(outs) if pod == last else torch.zeros_like(micro)
        out = SumAcross.apply(out + in_buf * 0, group)
        return (out.reshape(b, *x_local.shape[1:]),)

    run = local_map(body, out_placements=(x_pl,),
                    in_placements=(x_pl, *[p_pl] * len(keys)),
                    in_grad_placements=(x_grad, *[p_grad] * len(keys)),
                    device_mesh=mesh)
    return run(x, *leaves)[0]
