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
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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


def _causal_conv(
    w: torch.Tensor,                       # (K, C)
    bias: torch.Tensor,                    # (C,)
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
    out = F.silu(out + bias.to(xbc.dtype))
    if k > 1:
        if valid_len is not None and valid_len != s:
            new_state = xp[:, valid_len:valid_len + k - 1]
        else:
            new_state = xp[:, -(k - 1):]
    else:
        new_state = pad
    return out, new_state


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

    A DTensor ``x`` (parameters placed by ``runtime.sharding``) takes
    :func:`_mamba2_forward_sharded`; without a state (training) it returns
    the final SSM state alone (``conv`` None).
    """
    if isinstance(x, DTensor):
        return _mamba2_forward_sharded(cfg, p, x, state)
    bsz, s_in, _ = x.shape
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim
    z, xh, dt, log_decay, b, c, conv_state = _mamba_in(
        cfg, (0, n_heads), True, x, p.in_proj.w, p.conv_w, p.conv_b, p.dt_bias, p.a_log,
        state.conv if state is not None else None)
    s = xh.shape[1]
    h0 = (state.h if state is not None
          else torch.zeros((bsz, n_heads, hd, n_state), dtype=torch.float32, device=x.device))
    y, h_final = ops.mamba_chunk_scan(xh, dt, log_decay, b, c, h0, chunk=min(cfg.ssm_chunk, s_in))

    y = y + p.d_skip[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = common.rmsnorm(p.norm, y * F.silu(z), eps=cfg.norm_eps)
    y = y[:, :s_in] if s != s_in else y
    return linear(p.out_proj, y), MambaState(h=h_final, conv=conv_state)


def _mamba_in(cfg: ModelConfig, heads: tuple[int, int], lead: bool, x, w, conv_w, conv_b,
              dt_bias, a_log, conv_state=None):
    """The Mamba2 input path of the heads ``heads = (h0, h1)`` (all of
    them unsharded, a rank's on a mesh): ``x`` right-padded to whole chunks
    (padded steps get dt = 0: no decay, no input), then z, x (after the
    depthwise causal conv, ``(B, S, h1 - h0, P)``), dt and the log decay of
    those heads, and B and C, which every head needs; and the conv state
    (the last K-1 real inputs of the heads' x channels and of B and C).
    in_proj's columns are z, x, B, C, dt and the conv's channels x, B, C;
    the weights come whole and only these heads' columns (and channels) are
    used.  B and C's gradient is taken on the ``lead`` rank of the ranks
    that compute them alike (elsewhere it is zero, ``common.GradIf``), so
    that each rank's gradient is its part of the sum: its heads', and on
    the lead rank B's and C's."""
    d_inner, _, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim
    h0, h1 = heads
    c0, c1 = h0 * hd, h1 * hd
    s_in = x.shape[1]
    q = min(cfg.ssm_chunk, s_in)
    pad = (-s_in) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    bc = slice(2 * d_inner, 2 * d_inner + 2 * n_state)
    dt_cols = slice(2 * d_inner + 2 * n_state + h0, 2 * d_inner + 2 * n_state + h1)
    z = x @ w[:, c0:c1]
    xs = x @ w[:, d_inner + c0:d_inner + c1]
    dt_raw = x @ w[:, dt_cols]
    xb, wb, cwb, cbb = (common.GradIf.apply(t, lead) for t in
                        (x, w[:, bc], conv_w[:, d_inner:], conv_b[d_inner:]))
    x_state = bc_state = None
    if conv_state is not None:
        x_state, bc_state = conv_state[..., c0:c1], conv_state[..., d_inner:]
    xs, x_state = _causal_conv(conv_w[:, c0:c1], conv_b[c0:c1], xs, x_state, valid_len=s_in)
    bcm, bc_state = _causal_conv(cwb, cbb, xb @ wb, bc_state, valid_len=s_in)
    bm, cm = torch.split(bcm, [n_state, n_state], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias[h0:h1])
    if pad:
        dt = dt * (torch.arange(x.shape[1], device=x.device) < s_in)[None, :, None]
    ld = dt * -torch.exp(a_log[h0:h1])
    return (z, xs.reshape(*xs.shape[:2], h1 - h0, hd), dt, ld, bm, cm,
            torch.cat([x_state, bc_state], dim=-1))


def _mamba2_forward_sharded(cfg: ModelConfig, p: Mamba2, x: DTensor,
                            state: MambaState | None = None):
    """:func:`mamba2_forward` of a DTensor ``x`` (the residual stream: the
    batch over the data axes, whole over ``"model"``).

    ``in_proj``'s columns are split over ``"model"`` by the rules, at
    points that fall inside z, x, B, C and dt alike (296 columns at the
    reduced widths, 74 a rank over 4).  So the weight (and the conv's) is
    gathered whole, and each rank projects the columns of its own heads
    (the heads split over ``"model"`` when it divides them, else whole on
    every rank) and B and C, which every head needs
    (:func:`_mamba_in`, one ``local_map``); each weight's gradient is
    the sum of the ranks' parts.  The scan runs on each rank's batch and
    heads (``kernels.ops.mamba_chunk_scan``'s DTensor route: B5 and
    B5-bwd on local shards).  The skip, the gate, the norm over all of
    d_inner (its mean of squares summed across the head shards) and the
    out-projection (its rows split over ``"model"`` as the heads are) are
    DTensor ops; the output is ``Partial`` over ``"model"``.

    With a ``state`` (a prefill into a decode cache, in the cache's layout:
    ``h`` split on N, ``conv`` on its channels), the scan starts from
    ``h`` (B5's route brings it to the heads' layout) and the conv from the
    cached tail (gathered whole: (B, K-1, channels) is small); the final
    state comes back in the heads' layout and the new tail whole, and the
    caller writes both into the cache (``common.cache_set``)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    _, n_heads, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim
    s_in = x.shape[1]
    split = ("model" in names and mesh.size(names.index("model")) > 1
             and n_heads % mesh.size(names.index("model")) == 0)
    x_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements)
    x = x.redistribute(mesh, x_pl)
    model_i = names.index("model") if split else None
    heads_pl = tuple(Shard(2) if i == model_i else pl for i, pl in enumerate(x_pl))
    whole = tuple(Replicate() for _ in x_pl)
    summed = tuple(Partial() if pl == Shard(0) or i == model_i else Replicate()
                   for i, pl in enumerate(x_pl))
    x_grad = tuple(Partial() if i == model_i else pl for i, pl in enumerate(x_pl))
    if split:
        m = mesh.size(model_i)
        r = mesh.get_local_rank(model_i)
        heads, lead = (r * n_heads // m, (r + 1) * n_heads // m), r == 0
    else:
        heads, lead = (0, n_heads), True
    weights = tuple(t.redistribute(mesh, whole) for t in
                    (p.in_proj.w, p.conv_w, p.conv_b, p.dt_bias, p.a_log))
    tail_in = () if state is None else (state.conv.redistribute(mesh, x_pl),)
    x_cols = (heads[1] - heads[0]) * hd

    def local(xl, w, cw, cb, dtb, al, *tail):
        out = _mamba_in(cfg, heads, lead, xl, w, cw, cb, dtb, al, *tail)
        if not tail:
            return out[:6]
        # the new conv tail: this rank's heads' x channels, and B and C's
        return (*out[:6], out[6][..., :x_cols], out[6][..., x_cols:])

    outs = local_map(
        local, out_placements=(heads_pl,) * 4 + (x_pl, x_pl) + (heads_pl, x_pl)[:2 * len(tail_in)],
        in_placements=(x_pl,) + (whole,) * len(weights) + (x_pl,) * len(tail_in),
        in_grad_placements=(x_grad,) + (summed,) * len(weights) + (x_pl,) * len(tail_in),
        device_mesh=mesh)(x, *weights, *tail_in)
    z, xh, dt, ld, bm, cm = outs[:6]
    if state is None:
        b_local = x.to_local().shape[0]
        h0_pl = tuple(Shard(1) if pl == Shard(2) else pl for pl in heads_pl)
        h0_local = torch.zeros((b_local, heads[1] - heads[0], hd, n_state), dtype=torch.float32,
                               device=x.to_local().device)
        h0 = DTensor.from_local(h0_local, mesh, h0_pl, run_check=False)
        conv = None
    else:
        h0 = state.h
        conv = torch.cat([outs[6].redistribute(mesh, x_pl), outs[7]], dim=-1)
    y, h_final = ops.mamba_chunk_scan(xh, dt, ld, bm, cm, h0, chunk=min(cfg.ssm_chunk, s_in))
    y = y + p.d_skip[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(*y.shape[:2], n_heads * hd).to(x.dtype)
    y = common.rmsnorm(p.norm, y * F.silu(z), eps=cfg.norm_eps)
    if y.shape[1] != s_in:
        y = y[:, :s_in]
    return linear(p.out_proj, y), MambaState(h=h_final, conv=conv)


def mamba2_step(
    cfg: ModelConfig, p: Mamba2, x: torch.Tensor, state: MambaState
) -> tuple[torch.Tensor, MambaState]:
    """Single-token recurrence (decode path).  x: (B, 1, d).  A DTensor
    ``x`` takes :func:`_mamba2_step_sharded`."""
    if isinstance(x, DTensor):
        return _mamba2_step_sharded(cfg, p, x, state)
    bsz = x.shape[0]
    d_inner, n_heads, _ = _mamba_dims(cfg)
    z, xh, dt, ld, b, c, conv_state = _mamba_in(
        cfg, (0, n_heads), True, x, p.in_proj.w, p.conv_w, p.conv_b, p.dt_bias, p.a_log,
        state.conv)
    dt = dt[:, 0]                                                         # (B,H)
    g = torch.exp(ld[:, 0])                                               # (B,H)
    xh = xh[:, 0].to(torch.float32)
    bv = b[:, 0].to(torch.float32)                                        # (B,N)
    cv = c[:, 0].to(torch.float32)

    h = state.h * g[..., None, None] + (
        dt[:, :, None, None] * xh[..., :, None] * bv[:, None, None, :]
    )
    y = torch.einsum("bk,bhpk->bhp", cv, h) + p.d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = common.rmsnorm(p.norm, y * F.silu(z), eps=cfg.norm_eps)
    return linear(p.out_proj, y), MambaState(h=h, conv=conv_state)


def _mamba2_step_sharded(cfg: ModelConfig, p: Mamba2, x: DTensor,
                         state: MambaState) -> tuple[DTensor, MambaState]:
    """:func:`mamba2_step` of a DTensor ``x``, the state in the cache's
    layout (``h`` (B, H, P, N) split on N over ``"model"``, the conv tail
    on its channels).

    The in-projection's output (B, 1, 2·d_inner + 2N + H) is gathered
    whole over ``"model"`` (the weight stays where it lies), and so is the
    conv tail; then one ``local_map``: every rank runs the conv and the
    gates of all heads, and updates its own block of ``h`` in place of the
    whole (``h·g + dt·x·B`` needs B's entries of its N only); ``y = C·h``
    over a split N is a partial sum on each rank, all-reduced (a split H
    or P is all-gathered), then the skip, the gate and the norm.  One map,
    not a DTensor op a step of it: a decode step is host-bound.  Returns
    the out-projection's output and the new state (``h`` split as the
    cache's, the batch as x's; the tail whole)."""
    mesh = x.device_mesh
    d_inner, n_heads, n_state = _mamba_dims(cfg)
    hd = cfg.mamba_headdim
    x_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements)
    whole = tuple(Replicate() for _ in x_pl)
    x = x.redistribute(mesh, x_pl)
    proj = linear(p.in_proj, x).redistribute(mesh, x_pl)
    tail = state.conv.redistribute(mesh, x_pl)
    # h's own split, the batch as x's (the two differ where the cache's
    # batch is whole: ``transformer._stacks_whole``)
    h_pl = tuple(Shard(0) if xp == Shard(0) else Replicate() if hp == Shard(0) else hp
                 for xp, hp in zip(x_pl, state.h.placements))
    h_in = state.h.redistribute(mesh, h_pl)
    shape, offset = common.local_shape_offset(state.h.shape, mesh, h_pl)
    (h0, h1), (p0, p1), (n0, n1) = ((offset[d], offset[d] + shape[d]) for d in (1, 2, 3))
    weights = tuple(t.redistribute(mesh, whole) for t in
                    (p.conv_w, p.conv_b, p.dt_bias, p.a_log, p.d_skip, p.norm.scale))

    def local(pl, tl, hl, cw, cb, dtb, al, skip, scale):
        z = pl[..., :d_inner]
        xbc, new_tail = _causal_conv(cw, cb, pl[..., d_inner:2 * d_inner + 2 * n_state], tl)
        xs, bm, cm = torch.split(xbc[:, 0].to(torch.float32), [d_inner, n_state, n_state], -1)
        dt = F.softplus(pl[:, 0, 2 * d_inner + 2 * n_state:].to(torch.float32) + dtb)   # (B, H)
        g = torch.exp(dt * -torch.exp(al))
        xh = xs.reshape(-1, n_heads, hd)
        h = hl * g[:, h0:h1, None, None] + (
            dt[:, h0:h1, None, None] * xh[:, h0:h1, p0:p1, None] * bm[:, None, None, n0:n1])
        y = torch.einsum("bk,bhpk->bhp", cm[:, n0:n1], h)
        for i, hp in enumerate(h_pl):
            if hp == Shard(3):
                y = funcol.all_reduce(y, "sum", (mesh, i))
            elif hp in (Shard(1), Shard(2)):
                y = funcol.all_gather_tensor(y, hp.dim, (mesh, i))
        y = (y + skip[None, :, None] * xh).reshape(-1, 1, d_inner).to(pl.dtype)
        return common.rmsnorm(scale, y * F.silu(z), eps=cfg.norm_eps), h, new_tail

    y, h, new_tail = local_map(
        local, out_placements=(x_pl, h_pl, x_pl),
        in_placements=(x_pl, x_pl, h_pl) + (whole,) * len(weights),
        device_mesh=mesh)(proj, tail, h_in, *weights)
    return linear(p.out_proj, y), MambaState(h=h, conv=new_tail)


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
    q = common.split_heads(linear(p.wq, u), n_heads).to(f32) * (1.0 / math.sqrt(hd))
    k = common.split_heads(linear(p.wk, u), n_heads).to(f32)
    v = common.split_heads(linear(p.wv, u), n_heads).to(f32)
    i_raw, f_raw = torch.chunk(linear(p.w_if, u.to(f32)), 2, dim=-1)     # (B, S, H) each
    z = F.silu(linear(p.w_gatez, x))                                       # (B, S, up)
    return q, k, v, i_raw, f_raw, z


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h: torch.Tensor, z: torch.Tensor, dtype):
    h = common.rmsnorm(p.norm, h.to(dtype), eps=cfg.norm_eps)
    return linear(p.w_down, h * z)


def mlstm_forward(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                  state: XLSTMState | None = None) -> tuple[torch.Tensor, XLSTMState]:
    """The mLSTM over a sequence, one token at a time.  x: (B, S, d).

    A DTensor ``x`` runs the recurrence on each rank's batch and heads in
    one ``local_map`` (:func:`_recurrence_sharded`: a loop of S steps of
    DTensor ops would dispatch S times a layer), from ``state`` (a decode
    cache's, in the cache's layout) or an empty one; it returns the final
    state in the heads' layout, or no state without one."""
    bsz, s, _ = x.shape
    _, up, _ = _mlstm_dims(cfg)
    q, k, v, i_raw, f_raw, z = _mlstm_qkv(cfg, p, x)
    if isinstance(x, DTensor):

        def scan(ql, kl, vl, il, fl, *st):   # the rank's heads
            if not st:   # an empty state
                st = mlstm_init_state(cfg, ql.shape[0], device=ql.device)
                return _mlstm_loop(ql, kl, vl, il, fl,
                                   XLSTMState(*(t[:, :ql.shape[2]] for t in st)))[0]
            h, new = _mlstm_loop(ql, kl, vl, il, fl, XLSTMState(*st))
            return (h, *new)

        out = _recurrence_sharded(scan, q, (q, k, v, i_raw, f_raw), (2, 2, 2, 2, 2), (),
                                  state=() if state is None else tuple(state))
        h, new = (out, None) if state is None else (out[0], XLSTMState(*out[1:]))
        return _mlstm_out(cfg, p, common.merge_heads(h), z, x.dtype), new
    st = state if state is not None else mlstm_init_state(cfg, bsz, device=x.device)
    h, st = _mlstm_loop(q, k, v, i_raw, f_raw, st)
    return _mlstm_out(cfg, p, h.reshape(bsz, s, up), z, x.dtype), st


def _mlstm_loop(q, k, v, i_raw, f_raw, st: XLSTMState):
    """The mLSTM recurrence over the sequence: (B, S, H, P) hidden states
    and the final state."""
    hs = []
    for t in range(q.shape[1]):
        h, st = _mlstm_inner_step(q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t], st)
        hs.append(h)
    return torch.stack(hs, dim=1), st


def _recurrence_sharded(fn, like: DTensor, args: tuple, head_dims: tuple, params: tuple,
                        state: tuple = ()):
    """``fn(*local args, *local params, *local state)`` -> (B, S, H, P) on
    each rank's batch and heads, for DTensor ``args`` whose dimension
    ``head_dims[i]`` holds the heads, parameters whose dimension 1 does, and
    recurrent ``state`` tensors (B, H, ...), whose dimension 1 does; with a
    state, ``fn`` returns ``(h, *new state)`` and so does this, the new
    state in the heads' layout.  ``like``'s layout (the batch over the data
    axes) decides the batch; the heads split over ``"model"`` when it
    divides them, else every rank takes them all.  A parameter is gathered
    over the other axes, its gradient the sum of the batch shards' parts;
    a state arriving in another layout (a cache's) is brought to the
    heads'."""
    mesh = like.device_mesh
    names = mesh.mesh_dim_names or ()
    n_heads = args[0].shape[head_dims[0]]
    model_i = names.index("model") if "model" in names else None
    if model_i is not None and n_heads % mesh.size(model_i):
        model_i = None
    batch = [i for i, pl in enumerate(like.placements) if pl == Shard(0)]

    def layout(head_dim: int | None):
        return tuple(Shard(0) if i in batch else Shard(head_dim)
                     if i == model_i and head_dim is not None else Replicate()
                     for i in range(mesh.ndim))

    arg_pl = [layout(hd) for hd in head_dims]
    par_pl = [tuple(Shard(1) if i == model_i else Replicate() for i in range(mesh.ndim))
              for _ in params]
    par_grad = [tuple(Partial() if i in batch else pl for i, pl in enumerate(pl_))
                for pl_ in par_pl]
    st_pl = [layout(1)] * len(state)
    placed = [t.redistribute(mesh, pl) for t, pl in
              zip((*args, *params, *state), (*arg_pl, *par_pl, *st_pl))]
    return local_map(fn, out_placements=(layout(2), *st_pl),
                     in_placements=(*arg_pl, *par_pl, *st_pl),
                     in_grad_placements=(*arg_pl, *par_grad, *st_pl), device_mesh=mesh)(*placed)


def mlstm_step(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
               state: XLSTMState) -> tuple[torch.Tensor, XLSTMState]:
    """One-token mLSTM decode step.  x: (B, 1, d).  A DTensor ``x`` runs
    :func:`mlstm_forward`'s sharded recurrence on its one token."""
    if isinstance(x, DTensor):
        return mlstm_forward(cfg, p, x, state)
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


def _slstm_inner_step(r: torch.Tensor, bias: torch.Tensor, xt: torch.Tensor,
                      state: XLSTMState):
    """xt: (B, 4, H, P) pre-projected gate inputs; ``r`` (4, H, P, P) and
    ``bias`` (4, H, P) the recurrent weights and biases."""
    rec = torch.einsum("ghvp,bhp->bghv", r, state.h)          # (B, 4, H, P)
    pre = xt.to(torch.float32) + rec + bias[None]
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
    """The sLSTM over a sequence, one token at a time.  x: (B, S, d).

    A DTensor ``x`` runs the recurrence on each rank's batch and heads in
    one ``local_map`` (:func:`_recurrence_sharded`), with ``r`` and the
    biases gathered once a layer, from ``state`` (a decode cache's) or an
    empty one; it returns the final state in the heads' layout, or no
    state without one."""
    bsz, s, d = x.shape
    n_heads, hd = _xlstm_dims(cfg)
    gates = linear(p.w_in, x)
    if isinstance(x, DTensor):
        # whole over every rank first: the split of 4·d columns falls
        # across gates and heads alike
        gates = gates.redistribute(gates.device_mesh, tuple(
            pl if pl == Shard(0) else Replicate() for pl in gates.placements))
        gates = gates.reshape(bsz, s, 4, n_heads, hd)

        def scan(gl, r, bias, *st):   # the rank's heads
            if not st:   # an empty state
                st = slstm_init_state(cfg, gl.shape[0], device=gl.device)
                return _slstm_loop(r, bias, gl, XLSTMState(*(t[:, :gl.shape[3]] for t in st)))[0]
            h, new = _slstm_loop(r, bias, gl, XLSTMState(*st))
            return (h, *new)

        out = _recurrence_sharded(scan, x, (gates,), (3,), (p.r, p.b),
                                  state=() if state is None else tuple(state))
        h, new = (out, None) if state is None else (out[0], XLSTMState(*out[1:]))
        return _slstm_out(cfg, p, common.merge_heads(h), x.dtype), new
    st = state if state is not None else slstm_init_state(cfg, bsz, device=x.device)
    h, st = _slstm_loop(p.r, p.b, gates.reshape(bsz, s, 4, n_heads, hd), st)
    return _slstm_out(cfg, p, h.reshape(bsz, s, d), x.dtype), st


def _slstm_loop(r, bias, gates_in, st: XLSTMState):
    """The sLSTM recurrence over the sequence: (B, S, H, P) hidden states
    and the final state."""
    hs = []
    for t in range(gates_in.shape[1]):
        h, st = _slstm_inner_step(r, bias, gates_in[:, t], st)
        hs.append(h)
    return torch.stack(hs, dim=1), st


def slstm_step(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
               state: XLSTMState) -> tuple[torch.Tensor, XLSTMState]:
    """One-token sLSTM decode step.  x: (B, 1, d).  A DTensor ``x`` runs
    :func:`slstm_forward`'s sharded recurrence on its one token."""
    if isinstance(x, DTensor):
        return slstm_forward(cfg, p, x, state)
    bsz, _, d = x.shape
    n_heads, hd = _xlstm_dims(cfg)
    h, st = _slstm_inner_step(p.r, p.b, linear(p.w_in, x).reshape(bsz, 4, n_heads, hd), state)
    return _slstm_out(cfg, p, h.reshape(bsz, 1, d), x.dtype), st
