"""GQA attention: the layer, its decode caches, and two attention cores.

* :func:`naive_attention` materialises the ``(Sq, Sk)`` scores: short
  prompts and every decode step (plain tensor code, as in the JAX package).
* :func:`chunked_attention` is the long-prefill core: the flash-attention
  kernel through ``kernels.ops.flash_attention`` (on a CPU tensor, its
  plain version).

(MLA, M-RoPE, cross-attention and the sequence-sharded decode layout of
the JAX package are not ported yet.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import linear, rmsnorm

__all__ = [
    "KVCache",
    "Attention",
    "init_attention",
    "attention_forward",
    "naive_attention",
    "chunked_attention",
]

NEG_INF = -2.0**30


class KVCache(NamedTuple):
    """Per-layer decode cache.  k/v: (B, S_max, n_kv, hd); length: tokens
    already cached (a host integer)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


# ----------------------------------------------------------------------
# Core attention math
# ----------------------------------------------------------------------


def _mask_bias(
    mask_kind: str,
    q_pos: torch.Tensor,  # (Sq,) absolute positions of queries
    k_pos: torch.Tensor,  # (Sk,)
    window: int | None = None,
) -> torch.Tensor:
    """(Sq, Sk) additive bias in float32."""
    if mask_kind == "full":
        bias = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                           device=q_pos.device)
    elif mask_kind == "causal":
        bias = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
    else:
        raise ValueError(mask_kind)
    if window is not None:
        bias = torch.where(k_pos[None, :] > q_pos[:, None] - window, bias, NEG_INF)
    return bias


def _repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def naive_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    mask_kind: str = "causal",
    q_pos: torch.Tensor | None = None,
    k_pos: torch.Tensor | None = None,
    kv_valid_len: int | None = None,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention — materialises the (Sq, Sk) score matrix."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(sq, device=dev)
    if k_pos is None:
        k_pos = torch.arange(sk, device=dev)
    kr, vr = _repeat_kv(k, rep), _repeat_kv(v, rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32) * scale
    scores = scores + _mask_bias(mask_kind, q_pos, k_pos, window)[None, None]
    if kv_valid_len is not None:
        valid = torch.arange(sk, device=dev) < kv_valid_len
        scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask_kind: str = "causal",
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash-style online-softmax attention, (B, S, H, hd) layout.

    The flash-attention kernel on a CUDA tensor, its plain version on a CPU
    tensor; peak memory on the card is one tile of scores per block.
    Matches :func:`naive_attention` to float32 rounding (both take the
    products in float32 here; the JAX package's jnp version takes the
    score product in the input dtype)."""
    if mask_kind not in ("causal", "full"):
        raise ValueError(mask_kind)
    return ops.flash_attention(
        q, k, v, causal=mask_kind == "causal", window=window, scale=scale
    )


# ----------------------------------------------------------------------
# GQA attention layer
# ----------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen, cfg: ModelConfig, *, device) -> Attention:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = common.dtype_of(cfg.dtype)

    def dense(d_in, d_out, bias):
        return common.dense_init(gen, d_in, d_out, bias=bias, dtype=dt, device=device)

    p = Attention(
        dense(d, cfg.n_heads * hd, cfg.qkv_bias),
        dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
        dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
        dense(cfg.n_heads * hd, d, False),
    )
    if cfg.qk_norm:
        p.q_norm = common.rmsnorm_init(hd, device=device)
        p.k_norm = common.rmsnorm_init(hd, device=device)
    return p


def attention_forward(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,                   # (B, S, d)
    *,
    positions: torch.Tensor,           # (B, S)
    cache: KVCache | None = None,
    mask_kind: str = "causal",
    window: int | None = None,
    use_chunked: bool = False,
    ring: bool = False,                # sliding-window cache is a ring buffer
) -> tuple[torch.Tensor, KVCache | None]:
    """Self-attention with an optional decode cache.

    A cache's ``k``/``v`` tensors are written in place (slot writes into
    preallocated buffers); the returned :class:`KVCache` holds the same
    tensors and the new length."""
    if cfg.rope_variant == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP Queue A, item 13)")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p.wq, x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p.wk, x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p.wv, x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, eps=cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, eps=cfg.norm_eps)
    if cfg.rope_variant != "none":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)

    dev = x.device
    new_cache = None
    if cache is not None and ring:
        # --- sliding-window ring cache -------------------------------
        # slot of absolute position p is p % w; after the write the ring
        # holds the last min(L, w) tokens.
        w = cache.k.shape[1]
        q_pos = cache.length + torch.arange(s, device=dev)
        if s > w:  # only the last w tokens survive the write
            k_w, v_w, pos_w = k[:, -w:], v[:, -w:], q_pos[-w:]
        else:
            k_w, v_w, pos_w = k, v, q_pos
        slots = pos_w % w
        cache.k[:, slots] = k_w.to(cache.k.dtype)
        cache.v[:, slots] = v_w.to(cache.v.dtype)
        new_len = cache.length + s
        new_cache = KVCache(cache.k, cache.v, new_len)
        if s == 1:
            # decode: attend the ring.  Slot j holds absolute position
            # L−1−((L−1−j) mod w); unwritten slots map negative and are
            # pushed past the query, where the causal mask drops them.
            j = torch.arange(w, device=dev)
            k_pos = new_len - 1 - torch.remainder(new_len - 1 - j, w)
            k_pos = torch.where(k_pos >= 0, k_pos, 2**30)
            out = naive_attention(q, cache.k, cache.v, mask_kind="causal",
                                  q_pos=q_pos, k_pos=k_pos, window=w)
        else:
            # prefill: exact windowed attention over the fresh k/v (early
            # tokens must still see their full in-window history, which the
            # ring has overwritten)
            attn = chunked_attention if use_chunked else naive_attention
            out = attn(q, k, v, mask_kind="causal", window=w)
    elif cache is not None:
        # append this step's k/v at cache.length
        length = cache.length
        cache.k[:, length:length + s] = k.to(cache.k.dtype)
        cache.v[:, length:length + s] = v.to(cache.v.dtype)
        new_len = length + s
        new_cache = KVCache(cache.k, cache.v, new_len)
        out = naive_attention(
            q, cache.k, cache.v, mask_kind="causal",
            q_pos=length + torch.arange(s, device=dev),
            k_pos=torch.arange(cache.k.shape[1], device=dev),
            kv_valid_len=new_len, window=window,
        )
    else:
        attn = chunked_attention if use_chunked else naive_attention
        out = attn(q, k, v, mask_kind=mask_kind, window=window)

    out = out.reshape(b, s, cfg.n_heads * hd)
    return linear(p.wo, out), new_cache
