"""Plain float32 pieces of the reference: products, norms, rotary
positions, attention, the loss.  Plain PyTorch only; nothing of the
program.  Matrix products run with TF32 off (``plain_f32()``), so a
float32 product is a float32 product on the GPU too.

``Precision`` ``"f32"`` is the reference; ``"fp8"`` is the control of a
bfloat16 configuration: the reference computed in float8 e4m3 wherever
the program computes in bfloat16.  Every operand of a matrix product (the
projections, the feed-forward, the LM head, attention's scores and
weighted sum) and every activation the program holds in bfloat16 (the
embedding, each product's output, each norm's output, the residual stream
after each add) is rounded to e4m3 with one scale a tensor (its largest
magnitude onto 448); the products are then taken in float32.  Under
autograd the products of a weight's backward (the input's gradient and the
weight's) round their operands the same way, and every other rounding
passes the gradient through unchanged.  (The Mamba2 scan, which the port
takes in float32, stays float32 inside.)"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def plain_f32():
    """TF32 off for matrix products and convolutions, restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale, back in float32; the
    gradient passes through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


class Fp8Linear(torch.autograd.Function):
    """``x @ w`` with every operand of the forward and backward products
    rounded by :func:`fp8`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8(x) @ fp8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = fp8(g)
        gx = gq @ fp8(w).T
        gw = fp8(x).reshape(-1, x.shape[-1]).T @ gq.reshape(-1, g.shape[-1])
        return gx, gw


class Weights:
    """The weights by name, each read as float32 (a bfloat16 weight is
    widened exactly).  ``precision`` rounds the operands of products."""

    def __init__(self, tensors: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tensors = tensors
        self.precision = precision

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensors[name].to(torch.float32)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product, or an activation the program
        holds in its own precision, in this precision."""
        return fp8(t) if self.precision == "fp8" else t

    act = operand

    def linear(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        """``x @ w (+ b)`` of the weight ``<prefix>.w`` (``(d_in, d_out)``)."""
        w = self[prefix + ".w"]
        y = Fp8Linear.apply(x, w) if self.precision == "fp8" else x @ w
        if prefix + ".b" in self:
            y = y + self[prefix + ".b"]
        return self.act(y)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on (B, S, H, hd), the two halves of each head
    rotated together (the NeoX layout)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (positions.to(torch.float64)[:, None] * inv[None, :]).to(torch.float32)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, *, window: int | None, block: int = 1024,
              operand=lambda t: t) -> torch.Tensor:
    """Causal (windowed) attention of (B, S, H, hd) queries over (B, S, Hkv,
    hd) keys and values from position 0, query head ``i`` reading kv head
    ``i // (H / Hkv)``.  Key ``j`` is seen by query ``i`` iff ``j <= i`` and,
    with a window, ``j > i - window``.  Queries in blocks of ``block``, each
    against the keys it can see; ``operand`` rounds each product's
    operands."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    out = []
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        qi = q[:, i0:i1].reshape(b, i1 - i0, hkv, g, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", operand(qi), operand(k[:, j0:i1])) * scale
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(j0, i1, device=q.device)[None, :]
        keep = kp <= qp
        if window is not None:
            keep = keep & (kp > qp - window)
        p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", operand(p), operand(v[:, j0:i1]))
        out.append(o.reshape(b, i1 - i0, h, v.shape[-1]))
    return torch.cat(out, dim=1)


def swiglu(w: Weights, x: torch.Tensor, prefix: str) -> torch.Tensor:
    return w.linear(w.act(F.silu(w.linear(x, prefix + ".w_gate")) * w.linear(x, prefix + ".w_up")),
                    prefix + ".w_down")


def gqa_block(w: Weights, x: torch.Tensor, prefix: str, m: dict, positions, window):
    """The attention layer ``prefix`` (``wq``, ``wk``, ``wv``, ``wo``, biases
    where given) on the normed input ``x``."""
    b, s, _ = x.shape
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    q = w.linear(x, prefix + ".wq").reshape(b, s, m["n_heads"], hd)
    k = w.linear(x, prefix + ".wk").reshape(b, s, m["n_kv_heads"], hd)
    v = w.linear(x, prefix + ".wv").reshape(b, s, m["n_kv_heads"], hd)
    q, k = w.act(rope(q, positions, m["rope_theta"])), w.act(rope(k, positions, m["rope_theta"]))
    o = w.act(attention(q, k, v, window=window, operand=w.operand))
    return w.linear(o.reshape(b, s, m["n_heads"] * hd), prefix + ".wo")


def logits_at(w: Weights, h: torch.Tensor, m: dict, positions=None) -> torch.Tensor:
    """LM logits of the hidden states ``h`` (B, S, d), at ``positions`` of
    the sequence when given."""
    if positions is not None:
        h = h[:, positions]
    return w.linear(w.act(rmsnorm(h, w["final_norm.scale"], m["norm_eps"])), "lm_head")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL over the labels that are not -100."""
    keep = labels != -100
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp_min(1)
