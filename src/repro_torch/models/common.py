"""Shared model building blocks.

Parameters live in ``nn.Module``\\ s (:class:`Dense`, :class:`RMSNorm`,
:class:`Embedding`); the layer math is plain functions that take the
module holding a layer's parameters (``p``) and tensors, with the JAX
package's signatures and layouts, so the parity tests compare like with
like.  A dense weight is stored ``(d_in, d_out)`` and applied as
``x @ w``, as there.

Initialisers draw from an explicit ``torch.Generator`` on the device the
parameters are made on, with the same distributions as the JAX package
(not the same numbers: the two generators differ).  On the ``meta``
device they allocate nothing and draw nothing.  Parameters are trainable
(``requires_grad``); serving runs under ``torch.no_grad`` (``Model.prefill``
and ``Model.decode_step``), so it builds no graph.

Compute dtype follows the config (bf16 by default); normalisation
statistics and softmax accumulate in float32.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

__all__ = [
    "Dense",
    "RMSNorm",
    "Embedding",
    "dtype_of",
    "param",
    "normal",
    "dense_init",
    "embed_init",
    "rmsnorm_init",
    "linear",
    "rmsnorm",
    "apply_rope",
    "apply_mrope",
    "softmax_cross_entropy",
    "softmax_cross_entropy_chunked",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter (``Model.train_loss`` differentiates it)."""
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def normal(gen, shape, *, std: float = 1.0, dtype=torch.float32, device) -> torch.Tensor:
    """``N(0, std²)`` drawn in float32 from ``gen`` and cast to ``dtype``
    (as ``(jax.random.normal(k, shape) * std).astype(dtype)``).  On the
    ``meta`` device: an empty tensor, nothing drawn."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (x * std).to(dtype)


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``(d_in, d_out)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = param(w)
        self.b = None if b is None else param(b)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = param(scale)


class Embedding(nn.Module):
    def __init__(self, embedding: torch.Tensor):
        super().__init__()
        self.embedding = param(embedding)


# ----------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.bfloat16, device) -> Dense:
    w = normal(gen, (d_in, d_out), std=1.0 / math.sqrt(d_in), dtype=dtype, device=device)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w, b)


def embed_init(gen, vocab: int, d_model: int, *, dtype=torch.bfloat16, device) -> Embedding:
    return Embedding(normal(gen, (vocab, d_model), std=0.02, dtype=dtype, device=device))


def rmsnorm_init(d: int, *, dtype=torch.float32, device) -> RMSNorm:
    # norm scales stay float32: they are tiny and precision-sensitive
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


# ----------------------------------------------------------------------
# Core ops
# ----------------------------------------------------------------------


def linear(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def rmsnorm(p: RMSNorm | torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation in float32, result in ``x``'s dtype.  ``p`` is an
    :class:`RMSNorm` or its scale vector (the hybrid model keeps one
    scale row per shared-block invocation)."""
    scale = p if isinstance(p, torch.Tensor) else p.scale
    dt = x.dtype
    xf = x.to(torch.float32)
    rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf / rms) * scale).to(dt)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """(…, dim/2) rotation angles for integer positions, in float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(theta, exps)
    return positions[..., None].to(torch.float32) * inv_freq


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last axis (neox style) by the angles."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    ang = _rope_angles(positions, x.shape[-1], theta)    # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    sections: tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, hd); positions: (B, S, 3),
    the temporal / height / width position ids.

    The hd/2 rotary frequencies split into three contiguous sections, each
    driven by its own position stream; with three equal streams this is
    :func:`apply_rope` exactly (the same angles, in the same order)."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover hd/2 = {hd // 2}")
    s0, s1, _ = sections
    ang = torch.cat([
        _rope_angles(positions[..., 0], hd, theta)[..., :s0],
        _rope_angles(positions[..., 1], hd, theta)[..., s0:s0 + s1],
        _rope_angles(positions[..., 2], hd, theta)[..., s0 + s1:],
    ], dim=-1)                                           # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


# ----------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          ignore_id: int = -100) -> torch.Tensor:
    """Mean token NLL in float32 over the labels that are not ``ignore_id``.
    logits: (..., V); labels: (...)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = labels != ignore_id
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1)


def _ce_chunk(h, wc, col0: int, vocab: int, labels, m, l, gold):
    """One vocab chunk of the online log-sum-exp: the running max ``m``,
    sum ``l`` and gold logit ``gold`` after the columns ``col0 ..``."""
    chunk = wc.shape[1]
    logits = (h @ wc).to(torch.float32)                                # (B, S, c)
    cols = col0 + torch.arange(chunk, device=h.device)
    logits = torch.where(cols < vocab, logits, -1e30)
    m_new = torch.maximum(m, logits.amax(-1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= col0) & (labels < col0 + chunk)
    idx = (labels - col0).clamp(0, chunk - 1)
    gold_here = torch.gather(logits, -1, idx[..., None])[..., 0]
    return m_new, l, torch.where(in_chunk, gold_here, gold)


def softmax_cross_entropy_chunked(
    h: torch.Tensor,        # (B, S, d) final hidden states (already normed)
    head: Dense,            # lm_head, w (d, V)
    labels: torch.Tensor,   # (B, S)
    *,
    chunk: int = 8192,
    ignore_id: int = -100,
) -> torch.Tensor:
    """Cross-entropy without materialising the (B, S, V) logits: vocab
    chunks of ``chunk`` columns (the last zero-padded, its padding masked
    to -1e30) with an online log-sum-exp, as the JAX package's scan.  Each
    chunk runs under ``torch.utils.checkpoint``: autograd keeps only its
    inputs (the (B, S) carries) and recomputes its (B, S, chunk) logits in
    the backward, as ``jax.checkpoint(body)`` does, so live memory is one
    chunk of logits either way."""
    b, s, _ = h.shape
    w = head.w
    vocab = w.shape[1]
    pad = (-vocab) % chunk
    wp = torch.nn.functional.pad(w, (0, pad))
    labels_c = labels.clamp_min(0)
    f32 = torch.float32
    m = torch.full((b, s), -1e30, dtype=f32, device=h.device)
    l = torch.zeros((b, s), dtype=f32, device=h.device)
    gold = torch.zeros((b, s), dtype=f32, device=h.device)
    for col0 in range(0, vocab + pad, chunk):
        m, l, gold = torch.utils.checkpoint.checkpoint(
            _ce_chunk, h, wp[:, col0:col0 + chunk], col0, vocab, labels_c, m, l, gold,
            use_reentrant=False)
    nll = m + torch.log(l.clamp_min(1e-30)) - gold
    mask = labels != ignore_id
    return (nll * mask).sum() / mask.sum().clamp_min(1)
