"""Recurrent sequence mixers: Mamba2 (SSD) and the xLSTM blocks.

:func:`mamba2_forward` runs a whole sequence in the chunked SSD form: the
projections, the depthwise causal conv and the gates are tensor code
here, and the chunked scan itself — the intra-chunk quadratic term, the
read-out of the state entering each chunk and the state carried across
chunks — is the Mamba2 scan kernel through ``kernels.ops.mamba_chunk_scan``
(its plain version on a CPU tensor).  :func:`mamba2_step` is the one-token
recurrence of decode, plain tensor code.

xLSTM: the mLSTM (a matrix memory per head, exponential gates with a
stabiliser) and the sLSTM (a scalar memory with block-diagonal recurrent
weights).  As in the JAX package, a prompt runs one token at a time
(:func:`mlstm_forward`/:func:`slstm_forward` loop over the sequence) and
decode is the same step on one token; all state is float32, the
stabilisers starting at ``-1e30``.  (A chunkwise-parallel mLSTM, which the
JAX package does not have either, is later work.)
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
    "XLSTMState",
    "MLSTM",
    "SLSTM",
    "init_mlstm",
    "mlstm_init_state",
    "mlstm_forward",
    "mlstm_step",
    "init_slstm",
    "slstm_init_state",
    "slstm_forward",
    "slstm_step",
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


# ======================================================================
# xLSTM — mLSTM (matrix memory)
# ======================================================================


class XLSTMState(NamedTuple):
    c: torch.Tensor  # mLSTM: (B, H, P, P) matrix memory | sLSTM: (B, H, P) cell
    n: torch.Tensor  # normaliser: (B, H, P)
    m: torch.Tensor  # stabiliser: mLSTM (B, H) | sLSTM (B, H, P)
    h: torch.Tensor  # sLSTM hidden (B, H, P); carried unchanged (zeros) by the mLSTM


def _xlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """The mLSTM runs in the up-projected space: (n_heads, up, hd_up)."""
    up = int(cfg.xlstm_proj_factor * cfg.d_model)
    return cfg.n_heads, up, up // cfg.n_heads


class MLSTM(nn.Module):
    def __init__(self, w_up, w_gatez, wq, wk, wv, w_if, norm, w_down):
        super().__init__()
        self.w_up, self.w_gatez = w_up, w_gatez
        self.wq, self.wk, self.wv = wq, wk, wv
        self.w_if = w_if          # float32 (up, 2H): input and forget gate pre-activations
        self.norm = norm
        self.w_down = w_down


def init_mlstm(gen, cfg: ModelConfig, *, device) -> MLSTM:
    d = cfg.d_model
    n_heads, up, _ = _mlstm_dims(cfg)
    dt = common.dtype_of(cfg.dtype)

    def dense(d_in, d_out, dtype=dt):
        return common.dense_init(gen, d_in, d_out, dtype=dtype, device=device)

    return MLSTM(dense(d, up), dense(d, up), dense(up, up), dense(up, up), dense(up, up),
                 dense(up, 2 * n_heads, torch.float32),
                 common.rmsnorm_init(up, device=device), dense(up, d))


def mlstm_init_state(cfg: ModelConfig, bsz: int, *, device) -> XLSTMState:
    n_heads, _, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return XLSTMState(
        c=torch.zeros((bsz, n_heads, hd, hd), dtype=f32, device=device),
        n=torch.zeros((bsz, n_heads, hd), dtype=f32, device=device),
        m=torch.full((bsz, n_heads), -1e30, dtype=f32, device=device),
        h=torch.zeros((bsz, n_heads, hd), dtype=f32, device=device),
    )


def _mlstm_inner_step(q, k, v, i_raw, f_raw, state: XLSTMState):
    """One stabilised mLSTM update.  q/k/v: (B, H, P) float32; gates (B, H)."""
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + state.m - m_new)
    c = state.c * f_g[..., None, None] + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = state.n * f_g[..., None] + i_g[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(), torch.exp(-m_new))
    return num / den[..., None], XLSTMState(c=c, n=n, m=m_new, h=state.h)


def _mlstm_qkv(cfg: ModelConfig, p: MLSTM, x: torch.Tensor):
    """x: (B, S, d) → q/k/v in the up-projected head space, gate pre-acts, z."""
    bsz, s, _ = x.shape
    n_heads, _, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    u = linear(p.w_up, x)                                                  # (B, S, up)
    q = linear(p.wq, u).reshape(bsz, s, n_heads, hd).to(f32) * (1.0 / math.sqrt(hd))
    k = linear(p.wk, u).reshape(bsz, s, n_heads, hd).to(f32)
    v = linear(p.wv, u).reshape(bsz, s, n_heads, hd).to(f32)
    i_raw, f_raw = torch.chunk(linear(p.w_if, u.to(f32)), 2, dim=-1)     # (B, S, H) each
    z = F.silu(linear(p.w_gatez, x))                                       # (B, S, up)
    return q, k, v, i_raw, f_raw, z


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h: torch.Tensor, z: torch.Tensor, dtype):
    h = common.rmsnorm(p.norm, h.to(dtype), eps=cfg.norm_eps)
    return linear(p.w_down, h * z)


def mlstm_forward(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                  state: XLSTMState | None = None) -> tuple[torch.Tensor, XLSTMState]:
    """The mLSTM over a sequence, one token at a time.  x: (B, S, d)."""
    bsz, s, _ = x.shape
    _, up, _ = _mlstm_dims(cfg)
    q, k, v, i_raw, f_raw, z = _mlstm_qkv(cfg, p, x)
    st = state if state is not None else mlstm_init_state(cfg, bsz, device=x.device)
    hs = []
    for t in range(s):
        h, st = _mlstm_inner_step(q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t], st)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(bsz, s, up)
    return _mlstm_out(cfg, p, h, z, x.dtype), st


def mlstm_step(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
               state: XLSTMState) -> tuple[torch.Tensor, XLSTMState]:
    """One-token mLSTM decode step.  x: (B, 1, d)."""
    bsz = x.shape[0]
    _, up, _ = _mlstm_dims(cfg)
    q, k, v, i_raw, f_raw, z = _mlstm_qkv(cfg, p, x)
    h, st = _mlstm_inner_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0], state)
    return _mlstm_out(cfg, p, h.reshape(bsz, 1, up), z, x.dtype), st


# ======================================================================
# xLSTM — sLSTM (scalar memory, recurrent)
# ======================================================================


class SLSTM(nn.Module):
    def __init__(self, w_in, r, b, norm, w_up, w_down):
        super().__init__()
        self.w_in = w_in
        self.r = common.param(r)    # (4, H, P, P) float32: block-diagonal recurrent weights
        self.b = common.param(b)    # (4, H, P) float32
        self.norm = norm
        self.w_up = w_up
        self.w_down = w_down


def init_slstm(gen, cfg: ModelConfig, *, device) -> SLSTM:
    d = cfg.d_model
    n_heads, hd = _xlstm_dims(cfg)
    up = int(cfg.xlstm_proj_factor * d)
    dt = common.dtype_of(cfg.dtype)
    f32 = torch.float32
    # 4 gates (i, f, z, o), each with input weights and per-head recurrent
    # weights (the xLSTM "memory mixing")
    w_in = common.dense_init(gen, d, 4 * d, dtype=dt, device=device)
    r = common.normal(gen, (4, n_heads, hd, hd), std=1.0 / math.sqrt(hd), dtype=f32,
                      device=device)
    return SLSTM(w_in, r, torch.zeros((4, n_heads, hd), dtype=f32, device=device),
                 common.rmsnorm_init(d, device=device),
                 common.dense_init(gen, d, up, dtype=dt, device=device),
                 common.dense_init(gen, up, d, dtype=dt, device=device))


def slstm_init_state(cfg: ModelConfig, bsz: int, *, device) -> XLSTMState:
    n_heads, hd = _xlstm_dims(cfg)
    f32 = torch.float32

    def zeros():
        return torch.zeros((bsz, n_heads, hd), dtype=f32, device=device)

    return XLSTMState(c=zeros(), n=zeros(),
                      m=torch.full((bsz, n_heads, hd), -1e30, dtype=f32, device=device),
                      h=zeros())


def _slstm_inner_step(p: SLSTM, xt: torch.Tensor, state: XLSTMState):
    """xt: (B, 4, H, P) pre-projected gate inputs."""
    rec = torch.einsum("ghvp,bhp->bghv", p.r, state.h)        # (B, 4, H, P)
    pre = xt.to(torch.float32) + rec + p.b[None]
    i_raw, f_raw, z_raw, o_raw = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + state.m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z_raw)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    return h, XLSTMState(c=c, n=n, m=m_new, h=h)


def _slstm_out(cfg: ModelConfig, p: SLSTM, h: torch.Tensor, dtype):
    h = common.rmsnorm(p.norm, h.to(dtype), eps=cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    return linear(p.w_down, F.gelu(linear(p.w_up, h), approximate="tanh"))


def slstm_forward(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                  state: XLSTMState | None = None) -> tuple[torch.Tensor, XLSTMState]:
    """The sLSTM over a sequence, one token at a time.  x: (B, S, d)."""
    bsz, s, d = x.shape
    n_heads, hd = _xlstm_dims(cfg)
    st = state if state is not None else slstm_init_state(cfg, bsz, device=x.device)
    gates_in = linear(p.w_in, x).reshape(bsz, s, 4, n_heads, hd)
    hs = []
    for t in range(s):
        h, st = _slstm_inner_step(p, gates_in[:, t], st)
        hs.append(h)
    return _slstm_out(cfg, p, torch.stack(hs, dim=1).reshape(bsz, s, d), x.dtype), st


def slstm_step(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
               state: XLSTMState) -> tuple[torch.Tensor, XLSTMState]:
    """One-token sLSTM decode step.  x: (B, 1, d)."""
    bsz, _, d = x.shape
    n_heads, hd = _xlstm_dims(cfg)
    h, st = _slstm_inner_step(p, linear(p.w_in, x).reshape(bsz, 4, n_heads, hd), state)
    return _slstm_out(cfg, p, h.reshape(bsz, 1, d), x.dtype), st
