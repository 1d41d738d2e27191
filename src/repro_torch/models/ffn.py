"""Feed-forward layer: dense SwiGLU.  (The mixture-of-experts layer of the
JAX package is not ported yet.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import linear

__all__ = ["SwiGLU", "init_swiglu", "swiglu_forward"]


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
