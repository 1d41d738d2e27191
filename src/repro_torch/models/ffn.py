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

import torch
import torch.nn.functional as F
from torch import nn

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
    """Returns (output, aux_loss).  x: (B, S, d), flattened internally."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.num_experts
    xf = x.reshape(t, d)

    # --- routing (float32 for a stable softmax) -------------------------
    probs = torch.softmax(linear(p.router, xf.to(torch.float32)), dim=-1)   # (T, E)
    gate_vals, expert_ids = _top_k(probs, m.top_k)                         # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce) * m.aux_loss_weight

    # --- sort-based dispatch --------------------------------------------
    cap = _capacity(m, t)
    flat_expert = expert_ids.reshape(-1)                                   # (T k,)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    sorted_token = order // m.top_k
    # position in the expert's segment: global index - segment start
    seg_start = torch.searchsorted(sorted_expert, torch.arange(e, device=x.device))
    pos_in_expert = torch.arange(t * m.top_k, device=x.device) - seg_start[sorted_expert]
    keep = pos_in_expert < cap                                             # capacity drop
    slot = sorted_expert * cap + pos_in_expert

    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = xf[sorted_token[keep]]        # each kept pair owns its slot
    buf = buf.reshape(e, cap, d)

    # --- experts: batched products (E, C, d) x (E, d, f) ----------------
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down).reshape(e * cap, d)

    # --- combine: each token's k outputs, gate-weighted, summed in the
    # sorted order, which for one token is the order of its expert ids ---
    keep_tc = torch.empty_like(keep)
    keep_tc[order] = keep                                # back to (token, choice)
    slot_tc = torch.empty_like(slot)
    slot_tc[order] = slot
    by_expert = expert_ids.argsort(dim=1)                # a token's ids are distinct
    kept = keep_tc.view(t, m.top_k).gather(1, by_expert)
    rows = out_buf[torch.where(kept, slot_tc.view(t, m.top_k).gather(1, by_expert), 0)]
    gates = torch.where(kept, gate_vals.gather(1, by_expert), 0.0).to(x.dtype)
    contrib = rows * gates[..., None]                    # (T, k, d); dropped pairs 0
    combined = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        combined = combined + contrib[:, j]

    if p.shared is not None:
        combined = combined + swiglu_forward(p.shared, xf)
    return combined.reshape(b, s, d), aux
