"""Feed-forward layers: dense SwiGLU and the mixture-of-experts layer.

The MoE routes in float32 (softmax, top-k with the lower expert index first
on ties, gates renormalised, the Switch load-balancing loss) and dispatches
by sorting, as the JAX package does: the (token, choice) pairs are sorted
stably by expert, each pair's position in its expert's segment decides
whether it fits the capacity (pairs past it are dropped, the same pairs as
there), the kept tokens are scattered into an ``(E, C, d)`` buffer, the
experts run as batched products over their stacked ``(E, d, f)`` weights,
and each token gathers its k expert outputs back and sums them, weighted
by its gates, in the sorted order: deterministic, no atomics.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common
from repro_torch.models.common import linear

__all__ = ["SwiGLU", "init_swiglu", "swiglu_forward", "MoE", "init_moe", "moe_forward"]


class SwiGLU(nn.Module):
    def __init__(self, w_gate: common.Dense, w_up: common.Dense, w_down: common.Dense):
        super().__init__()
        self.w_gate = w_gate
        self.w_up = w_up
        self.w_down = w_down


def init_swiglu(gen, d_model: int, d_ff: int, *, dtype=torch.bfloat16, device) -> SwiGLU:
    return SwiGLU(
        common.dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        common.dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        common.dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
    )


def swiglu_forward(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return linear(p.w_down, F.silu(linear(p.w_gate, x)) * linear(p.w_up, x))


# ----------------------------------------------------------------------
# Mixture of Experts
# ----------------------------------------------------------------------


class MoE(nn.Module):
    """``router`` a float32 :class:`~repro_torch.models.common.Dense`;
    ``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down`` ``(E, f, d)`` stacked
    expert weights; ``shared`` the shared experts' SwiGLU, or None."""

    def __init__(self, router, w_gate, w_up, w_down, shared=None):
        super().__init__()
        self.router = router
        self.w_gate = common.param(w_gate)
        self.w_up = common.param(w_up)
        self.w_down = common.param(w_down)
        self.shared = shared


def init_moe(gen, cfg: ModelConfig, *, device) -> MoE:
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    d = cfg.d_model
    dt = common.dtype_of(cfg.dtype)

    def stacked(d_in, d_out):
        std = 1.0 / d_in ** 0.5
        return common.normal(gen, (m.num_experts, d_in, d_out), std=std, dtype=dt,
                             device=device)

    router = common.dense_init(gen, d, m.num_experts, dtype=torch.float32, device=device)
    w_gate, w_up = stacked(d, m.d_ff_expert), stacked(d, m.d_ff_expert)
    w_down = stacked(m.d_ff_expert, d)
    shared = None
    if m.num_shared_experts:
        shared = init_swiglu(gen, d, m.num_shared_experts * m.d_ff_shared, dtype=dt,
                             device=device)
    return MoE(router, w_gate, w_up, w_down, shared)


def _capacity(m: MoEConfig, n_tokens: int) -> int:
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    # rounded up to a multiple of 8, as the JAX package aligns it
    return max(8, -(-cap // 8) * 8)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with the lower index first among equal
    values (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).  x: (B, S, d), flattened internally.  A
    DTensor ``x`` takes :func:`_moe_forward_sharded`."""
    if isinstance(x, DTensor):
        return _moe_forward_sharded(cfg, p, x)
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    e = m.num_experts
    out, me_sum, ce_sum = _moe_local(cfg, (0, e), True, None, [], t, x, p.router.w,
                                     p.w_gate, p.w_up, p.w_down)
    # load-balancing auxiliary loss (Switch-style)
    aux = e * torch.sum((me_sum / t) * (ce_sum / t)) * m.aux_loss_weight
    if p.shared is not None:
        out = out + swiglu_forward(p.shared, x)
    return out, aux


# ----------------------------------------------------------------------
# Mixture of Experts on a mesh
# ----------------------------------------------------------------------


def _rank_offsets(counts: torch.Tensor, mesh, dims: list[int]) -> torch.Tensor:
    """Each expert's pairs on the batch ranks before this one, in the
    global batch's order: ``counts`` (E,) gathered over the mesh
    dimensions ``dims`` (the outermost first, as the batch is laid out),
    summed over the ranks whose coordinates come first."""
    table, index, stride = counts[None], 0, 1
    for i in reversed(dims):
        group = mesh.get_group(i)
        parts = [torch.empty_like(table) for _ in range(mesh.size(i))]
        dist.all_gather(parts, table.contiguous(), group=group)
        table = torch.cat(parts)
        index += mesh.get_local_rank(i) * stride
        stride *= mesh.size(i)
    return table[:index].sum(0)


def _moe_local(cfg: ModelConfig, experts: tuple[int, int], lead: bool, mesh,
               prefix_dims: list[int], n_tokens: int, x, router_w, w_gate, w_up, w_down):
    """:func:`moe_forward` over the tokens ``x`` (all of them, or one
    rank's): the routing, each pair's position in its expert's segment of
    the whole batch of ``n_tokens`` (its position here plus the pairs of
    the ranks in ``prefix_dims`` of ``mesh`` before this one; none
    unsharded), the capacity drop at the whole batch's capacity, the
    experts ``experts = (e0, e1)`` on their kept pairs, and each token's
    gate-weighted sum of those experts' outputs.  Returns the sum, and the
    router's probabilities and top-1 counts summed over the tokens (the
    load-balancing loss's parts; their gradient taken on the ``lead`` rank
    of the ranks that compute them alike)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    e0, e1 = experts
    xf = x.reshape(t, d)
    # --- routing (float32 for a stable softmax) --------------------------
    probs = torch.softmax(xf.to(torch.float32) @ router_w, dim=-1)           # (T, E)
    gate_vals, expert_ids = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me_sum = common.GradIf.apply(probs, lead).sum(0)
    ce_sum = F.one_hot(expert_ids[:, 0], e).to(torch.float32).sum(0)

    # --- sort-based dispatch ---------------------------------------------
    cap = _capacity(m, n_tokens)
    flat_expert = expert_ids.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    seg_start = torch.searchsorted(sorted_expert, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - seg_start[sorted_expert]
    # each expert's pairs here (a bincount whose shape does not depend on
    # the ids, so that the step also runs on fake tensors)
    counts = (flat_expert[:, None] == torch.arange(e, device=x.device)).sum(0)
    offsets = _rank_offsets(counts, mesh, prefix_dims)
    keep = offsets[sorted_expert] + pos < cap                  # the whole batch's drops
    mine = keep & (sorted_expert >= e0) & (sorted_expert < e1)
    slot = (sorted_expert - e0).clamp(0, e1 - e0 - 1) * cap + pos.clamp(max=cap - 1)

    # each kept pair owns its slot: every slot's token (the pairs not kept
    # here write a spare slot), gathered where a pair fills the slot
    rows = (e1 - e0) * cap
    at = torch.where(mine, slot, rows)
    src = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
    src[at] = sorted_token
    filled = torch.zeros(rows + 1, dtype=torch.bool, device=x.device)
    filled[at] = mine
    buf = torch.where(filled[:rows, None], xf[src[:rows]], 0).reshape(e1 - e0, cap, d)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_buf = torch.bmm(h, w_down).reshape((e1 - e0) * cap, d)

    # --- combine: each token's k outputs, gate-weighted, summed in the
    # sorted order, which for one token is the order of its expert ids ---
    mine_tc = torch.empty_like(mine)
    mine_tc[order] = mine                               # back to (token, choice)
    slot_tc = torch.empty_like(slot)
    slot_tc[order] = slot
    by_expert = expert_ids.argsort(dim=1)
    kept = mine_tc.view(t, k).gather(1, by_expert)
    rows = out_buf[torch.where(kept, slot_tc.view(t, k).gather(1, by_expert), 0)]
    gates = torch.where(kept, gate_vals.gather(1, by_expert), 0.0).to(x.dtype)
    contrib = rows * gates[..., None]
    combined = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        combined = combined + contrib[:, j]
    return combined.reshape(b, s, d), me_sum, ce_sum


def _moe_forward_sharded(cfg: ModelConfig, p: MoE, x: DTensor) -> tuple[DTensor, DTensor]:
    """:func:`moe_forward` of a DTensor ``x`` (the batch over the data
    axes, whole over ``"model"``), in the experts' layout
    (``runtime.sharding``'s ``expert_mode``).

    * ``"ep_model"`` (experts over ``"model"``, FSDP over ``"data"``): each
      rank routes its own tokens and runs its model rank's experts on the
      kept pairs that route to them; the output is ``Partial`` over
      ``"model"``.
    * ``"ep_data_tp_model"`` (experts over ``"data"``, d_ff over
      ``"model"``): the tokens move, the weights do not.  x is gathered
      over ``"data"``, each rank routes the tokens of its data group and
      runs its experts (its slice of d_ff) on them, and the outputs are
      summed back onto their tokens' ranks (a reduce-scatter over
      ``"data"``; ``Partial`` over ``"model"``).

    The capacity is the whole batch's, and a pair is kept iff its position
    in its expert's segment, in the whole batch's token order, is below it:
    each rank counts its pairs per expert, and an exclusive prefix sum of
    those counts over the batch ranks whose tokens it does not see gives
    each of its pairs the position it has in the reference's dispatch.
    The router's softmax and the load-balancing loss are means over the
    whole batch; the combine's sum over a token's experts runs in another
    order across ranks (rounding)."""
    m = cfg.moe
    mesh = x.device_mesh
    n = mesh.ndim
    x_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements)
    x = x.redistribute(mesh, x_pl)
    batch = [i for i in range(n) if x_pl[i] == Shard(0)]
    w_pl = p.w_gate.placements
    expert_dims = [i for i in range(n) if w_pl[i] == Shard(0)]
    gathered = [i for i in batch if i in expert_dims]          # the tokens move here
    prefix = [i for i in batch if i not in gathered]
    # the d_ff split kept (TP) on mesh dimensions that do not carry the batch
    tp = [i for i in range(n) if i not in batch and w_pl[i] == Shard(2)]
    split = expert_dims + tp                                  # the weights' own dims
    seen_pl = tuple(Replicate() if i in gathered else x_pl[i] for i in range(n))
    out_pl = tuple(Partial() if i in gathered or i in split else seen_pl[i] for i in range(n))
    rep_pl = tuple(Replicate() for _ in range(n))

    def w_layout(f_dim: int):
        keep = tuple(Shard(0) if i in expert_dims else Shard(f_dim) if i in tp else Replicate()
                     for i in range(n))
        grad = tuple(Partial() if pl == Replicate() and i in batch else pl
                     for i, pl in enumerate(keep))
        return keep, grad

    (g_pl, g_grad), (d_pl, d_grad) = w_layout(2), w_layout(1)
    router_grad = tuple(Partial() if i in batch or i in split else Replicate() for i in range(n))
    x_grad = tuple(Partial() if i in gathered or i in split else seen_pl[i] for i in range(n))
    sums_pl = tuple(Partial() if i in prefix else Replicate() for i in range(n))

    per = m.num_experts // math.prod(mesh.size(i) for i in expert_dims)
    coord = 0
    for i in expert_dims:
        coord = coord * mesh.size(i) + mesh.get_local_rank(i)
    lead = all(mesh.get_local_rank(i) == 0 for i in gathered + split)
    n_tokens = x.shape[0] * x.shape[1]

    def local(xl, rw, wg, wu, wd):
        return _moe_local(cfg, (coord * per, (coord + 1) * per), lead, mesh, prefix, n_tokens,
                          xl, rw, wg, wu, wd)

    args = [x.redistribute(mesh, seen_pl), p.router.w.redistribute(mesh, rep_pl),
            p.w_gate.redistribute(mesh, g_pl), p.w_up.redistribute(mesh, g_pl),
            p.w_down.redistribute(mesh, d_pl)]
    out, me_sum, ce_sum = local_map(
        local, out_placements=(out_pl, sums_pl, sums_pl),
        in_placements=(seen_pl, rep_pl, g_pl, g_pl, d_pl),
        in_grad_placements=(x_grad, router_grad, g_grad, g_grad, d_grad),
        device_mesh=mesh)(*args)
    if gathered:
        out = out.redistribute(mesh, tuple(x_pl[i] if i in gathered else pl
                                           for i, pl in enumerate(out_pl)))
    me, ce = (t.redistribute(mesh, rep_pl) / n_tokens for t in (me_sum, ce_sum))
    aux = m.num_experts * torch.sum(me * ce) * m.aux_loss_weight
    if p.shared is not None:
        out = out + swiglu_forward(p.shared, x)
    return out, aux
