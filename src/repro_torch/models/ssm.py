"""Mamba2 (SSD) sequence mixer.

:func:`mamba2_forward` runs a whole sequence in the chunked SSD form: the
projections, the depthwise causal conv and the gates are tensor code
here, and the chunked scan itself — the intra-chunk quadratic term, the
read-out of the state entering each chunk and the state carried across
chunks — is the Mamba2 scan kernel through ``kernels.ops.mamba_chunk_scan``
(its plain version on a CPU tensor).  :func:`mamba2_step` is the one-token
recurrence of decode, plain tensor code.

(The xLSTM blocks of the JAX package are not ported yet.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import linear

__all__ = [
    "MambaState",
    "Mamba2",
    "init_mamba2",
    "mamba2_forward",
    "mamba2_step",
]


class MambaState(NamedTuple):
    """Decode state: SSM state h (B, H, P, N) + conv ring buffer."""

    h: torch.Tensor          # (B, H, P, N) float32
    conv: torch.Tensor       # (B, conv_w - 1, d_conv_in)


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.mamba_headdim
    return d_inner, n_heads, cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, in_proj, conv_w, conv_b, a_log, d_skip, dt_bias, norm, out_proj):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w = common.param(conv_w)    # (K, d_conv_in)
        self.conv_b = common.param(conv_b)
        self.a_log = common.param(a_log)      # (H,) float32
        self.d_skip = common.param(d_skip)
        self.dt_bias = common.param(dt_bias)
        self.norm = norm
        self.out_proj = out_proj


def init_mamba2(gen, cfg: ModelConfig, *, device) -> Mamba2:
    d = cfg.d_model
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    dt = common.dtype_of(cfg.dtype)
    f32 = torch.float32
    d_in_proj = 2 * d_inner + 2 * n_state + n_heads   # z, x, B, C, dt
    d_conv_in = d_inner + 2 * n_state                 # conv over [x, B, C]
    in_proj = common.dense_init(gen, d, d_in_proj, dtype=dt, device=device)
    conv_w = common.normal(gen, (cfg.ssm_conv, d_conv_in),
                           std=1.0 / math.sqrt(cfg.ssm_conv), dtype=dt, device=device)
    out_proj = common.dense_init(gen, d_inner, d, dtype=dt, device=device)
    return Mamba2(
        in_proj,
        conv_w,
        torch.zeros((d_conv_in,), dtype=dt, device=device),
        torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=f32, device=device)),
        torch.ones((n_heads,), dtype=f32, device=device),
        torch.zeros((n_heads,), dtype=f32, device=device),
        common.rmsnorm_init(d_inner, device=device),
        out_proj,
    )


def _mamba_project(cfg: ModelConfig, p: Mamba2, x: torch.Tensor):
    """Shared input path: the in-projection split into (z, xBC, dt)."""
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    zxbcdt = linear(p.in_proj, x)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * n_state, n_heads], dim=-1)
    return z, xbc, dt_raw


def _causal_conv(
    p: Mamba2,
    xbc: torch.Tensor,
    conv_state: torch.Tensor | None,
    valid_len: int | None = None,
):
    """Depthwise causal conv over time.  xbc: (B, S, C).

    An explicit sum of shifted products (no cuDNN convolution, whose float32
    path may run in TF32).  ``valid_len`` marks the number of real tokens
    when the caller right-padded the sequence; the returned conv state then
    holds the last K−1 *real* inputs so decode continues after a padded
    prefill.
    """
    w = p.conv_w  # (K, C)
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                   # (B, S+K-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(xbc.dtype)
    out = F.silu(out + p.conv_b.to(xbc.dtype))
    if k > 1:
        if valid_len is not None and valid_len != s:
            new_state = xp[:, valid_len:valid_len + k - 1]
        else:
            new_state = xp[:, -(k - 1):]
    else:
        new_state = pad
    return out, new_state


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    return torch.split(xbc, [d_inner, n_state, n_state], dim=-1)


def mamba2_forward(
    cfg: ModelConfig,
    p: Mamba2,
    x: torch.Tensor,                       # (B, S, d)
    state: MambaState | None = None,
) -> tuple[torch.Tensor, MambaState]:
    """Chunked SSD over a full sequence.  Returns output + final state.

    Sequences that don't divide the chunk are right-padded internally;
    padded steps get dt = 0 (no decay, no input contribution), so the
    final state is exactly the state after the real tokens.
    """
    bsz, s_in, _ = x.shape
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim
    q = min(cfg.ssm_chunk, s_in)
    pad = (-s_in) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    s = s_in + pad

    z, xbc, dt_raw = _mamba_project(cfg, p, x)
    xbc, conv_state = _causal_conv(p, xbc, state.conv if state is not None else None,
                                   valid_len=s_in)
    xs, b, c = _split_xbc(cfg, xbc)

    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)              # (B,S,H)
    if pad:
        dt = dt * (torch.arange(s, device=x.device) < s_in)[None, :, None]
    a = -torch.exp(p.a_log)                                             # (H,)
    log_decay = dt * a                                                  # (B,S,H)

    xh = xs.reshape(bsz, s, n_heads, hd)
    h0 = (state.h if state is not None
          else torch.zeros((bsz, n_heads, hd, n_state), dtype=torch.float32, device=x.device))
    y, h_final = ops.mamba_chunk_scan(xh, dt, log_decay, b, c, h0, chunk=q)

    y = y + p.d_skip[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = common.rmsnorm(p.norm, y * F.silu(z), eps=cfg.norm_eps)
    y = y[:, :s_in] if pad else y
    return linear(p.out_proj, y), MambaState(h=h_final, conv=conv_state)


def mamba2_step(
    cfg: ModelConfig, p: Mamba2, x: torch.Tensor, state: MambaState
) -> tuple[torch.Tensor, MambaState]:
    """Single-token recurrence (decode path).  x: (B, 1, d)."""
    bsz = x.shape[0]
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim

    z, xbc, dt_raw = _mamba_project(cfg, p, x)
    xbc, conv_state = _causal_conv(p, xbc, state.conv)
    xs, b, c = _split_xbc(cfg, xbc)

    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)[:, 0]           # (B,H)
    a = -torch.exp(p.a_log)
    g = torch.exp(dt * a)                                                 # (B,H)
    xh = xs[:, 0].reshape(bsz, n_heads, hd).to(torch.float32)
    bv = b[:, 0].to(torch.float32)                                        # (B,N)
    cv = c[:, 0].to(torch.float32)

    h = state.h * g[..., None, None] + (
        dt[:, :, None, None] * xh[..., :, None] * bv[:, None, None, :]
    )
    y = torch.einsum("bk,bhpk->bhp", cv, h) + p.d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = common.rmsnorm(p.norm, y * F.silu(z), eps=cfg.norm_eps)
    return linear(p.out_proj, y), MambaState(h=h, conv=conv_state)
