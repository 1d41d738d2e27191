"""The hybrid family's plain float32 forward (zamba2-1.2b as the port
defines it): embedding; ``n_layers / every`` groups, each of ``every``
Mamba2 layers (no pre-norm, a residual add each) and then the one shared
block (attention and SwiGLU, each pre-normed by the group's own scale
row, windowed causal attention); the final norm and the LM head.

A Mamba2 layer on x (B, S, d): ``in_proj`` gives z, x, B, C and dt (in that
column order); a depthwise causal convolution of width K and SiLU over
[x, B, C]; ``dt = softplus(dt + dt_bias)``, ``A = -exp(a_log)``; the SSD
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t
+ D x_t`` per head of P channels, from ``h = 0``; then ``rmsnorm(y *
silu(z))`` and ``out_proj``.  The recurrence is taken in chunks (the same
sum regrouped), in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from bench.reference.common import Weights, gqa_block, rmsnorm, swiglu

CHUNK = 256


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: ``out_t = sum_i w_i
    x_{t-K+1+i} + b`` (zeros before the start); x (B, S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b


def ssd(x, dt, a, bm, cm):
    """The SSD recurrence from a zero state.  x (B, S, H, P), dt (B, S, H),
    a (H,) negative, bm and cm (B, S, N).  Returns y (B, S, H, P)."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(CHUNK, s)
    pad = (-s) % q
    if pad:   # padded steps carry dt = 0: no decay, no input
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nc = x.shape[1] // q
    x = x.reshape(bsz, nc, q, h, p)
    dt = dt.reshape(bsz, nc, q, h)
    bm, cm = bm.reshape(bsz, nc, q, n), cm.reshape(bsz, nc, q, n)
    cum = torch.cumsum(dt * a, dim=2)                                  # (B, nc, Q, H)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # (B, nc, t, s, H)
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", cm, bm)
    weight = cb[..., None] * decay * dt[:, :, None, :, :]              # (B, nc, t, s, H)
    y = torch.einsum("bctsh,bcshp->bcthp", weight, x)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dt                   # (B, nc, Q, H)
    own = torch.einsum("bcshp,bcsn->bchpn", to_end[..., None] * x, bm)
    states, hcur = [], x.new_zeros(bsz, h, p, n)
    for c in range(nc):
        states.append(hcur)
        hcur = hcur * torch.exp(cum[:, c, -1])[:, :, None, None] + own[:, c]
    enter = torch.stack(states, dim=1)                                 # (B, nc, H, P, N)
    y = y + torch.einsum("bctn,bchpn->bcthp", cm, enter) * torch.exp(cum)[..., None]
    return y.reshape(bsz, nc * q, h, p)[:, :s]


def mamba2(w: Weights, x: torch.Tensor, prefix: str, m: dict) -> torch.Tensor:
    d_inner = m["ssm_expand"] * m["d_model"]
    n, p = m["ssm_state"], m["mamba_headdim"]
    heads = d_inner // p
    zxbcdt = w.linear(x, prefix + ".in_proj")
    z, xs, bc, dt = torch.split(zxbcdt, [d_inner, d_inner, 2 * n, heads], dim=-1)
    cw, cb = w[prefix + ".conv_w"], w[prefix + ".conv_b"]
    xs = w.act(F.silu(causal_conv(xs, cw[:, :d_inner], cb[:d_inner])))
    bc = w.act(F.silu(causal_conv(bc, cw[:, d_inner:], cb[d_inner:])))
    bm, cm = bc[..., :n], bc[..., n:]
    dt = F.softplus(dt + w[prefix + ".dt_bias"])
    xh = xs.reshape(*xs.shape[:2], heads, p)
    y = ssd(xh, dt, -torch.exp(w[prefix + ".a_log"]), bm, cm)
    y = w.act(y + w[prefix + ".d_skip"][:, None] * xh)
    y = w.act(rmsnorm(w.act(y.reshape(*xs.shape) * F.silu(z)), w[prefix + ".norm.scale"],
                      m["norm_eps"]))
    return w.linear(y, prefix + ".out_proj")


def hidden(w: Weights, tokens: torch.Tensor, m: dict, *, checkpoint: bool = False):
    """The final hidden states (B, S, d), before the final norm, of token
    rows from position 0.  ``checkpoint`` recomputes each layer in the
    backward (for a reference training step that fits)."""
    eps = m["norm_eps"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = w.act(w["embed.embedding"][tokens])
    every = m["shared_attn_every"]

    def run(fn, *args):
        if checkpoint:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for g in range(m["n_layers"] // every):
        for i in range(every):
            x = w.act(x + run(lambda x_, pre=f"mamba.{g}.{i}": mamba2(w, x_, pre, m), x))

        def shared(x_, g=g):
            x_ = w.act(x_ + gqa_block(w, w.act(rmsnorm(x_, w["shared_ln"][g], eps)),
                                      "shared_attn", m, positions, m["attn_window"]))
            return w.act(x_ + swiglu(w, w.act(rmsnorm(x_, w["shared_ln2"][g], eps)),
                                     "shared_ffn"))

        x = run(shared, x)
    return x
