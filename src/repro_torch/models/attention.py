"""Attention: the GQA layer (qk_norm, bias, RoPE or M-RoPE, cross-attention,
sliding-window ring caches), DeepSeek-V2 MLA (multi-head latent attention),
their decode caches, and two attention cores.

* :func:`naive_attention` materialises the ``(Sq, Sk)`` scores: short
  prompts, ring and cross-attention decode steps (plain tensor code, as in
  the JAX package).
* :func:`chunked_attention` is the long-prefill core: the flash-attention
  kernel through ``kernels.ops.flash_attention`` (on a CPU tensor, its
  plain version).  It takes value heads narrower than the query/key heads,
  as MLA's are.

**The empty-cache prefill route.**  A prefill into a cache that holds
nothing yet (``cache.length == 0``, ``s > 1``) with ``use_chunked`` set
writes its k/v (MLA: its latents) into the cache and attends the fresh k/v
with :func:`chunked_attention`, where the JAX package runs
``naive_attention`` over the whole ``(B, H, S, S_max)`` score matrix of the
cache (MLA: the absorbed form).  It is the same function: the cache's slots
at and past ``s`` are masked by ``kv_valid_len`` to a score of ``NEG_INF``,
whose ``exp`` is exactly 0 in float32, so they add nothing to the softmax;
the slots below ``s`` hold exactly the fresh k/v; and the causal mask of
positions ``0 .. s-1`` is the same on both sides.  (MLA's absorbed form
multiplies by ``W_UK`` and ``W_UV`` on the other side of the same products.)
The serving engine admits each wave into a fresh cache, so every engine
prefill starts at length 0; at deepseek-v2's widths the score matrix of 4
prompts of 6 144 tokens would need 78 GB of float32.  Every other cached
call keeps the reference's route, except the next one.

**The one-token decode over a (non-ring) cache** takes the grouped-query
einsum over the cache as it is stored (:func:`_flash_decode_attention`, the
JAX package's sequence-sharded decode layout, which it takes when
``set_decode_flash_partitioning(True)``), never repeating K/V to the query
heads as ``naive_attention`` would.  It is the same function as the
reference's naive decode, with float32 products throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import linear, rmsnorm

__all__ = [
    "KVCache",
    "Attention",
    "init_attention",
    "attention_forward",
    "MLACache",
    "MLA",
    "init_mla",
    "mla_forward",
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
    bias = _mask_bias(mask_kind, q_pos, k_pos, window)[None, None]
    scores = scores + common.replicated_like(bias, scores)
    if kv_valid_len is not None:
        valid = torch.arange(sk, device=dev) < kv_valid_len
        valid = common.replicated_like(valid[None, None, None, :], scores)
        scores = torch.where(valid, scores, NEG_INF)
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
    """Flash-style online-softmax attention, (B, S, H, hd) layout; ``v`` may
    have narrower heads (B, S, Hkv, hd_v), and the result has v's width.

    The flash-attention kernel on a CUDA tensor, its plain version on a CPU
    tensor; peak memory on the card is one tile of scores per block.
    Matches :func:`naive_attention` to float32 rounding (both take the
    products in float32 here; the JAX package's jnp version takes the
    score product in the input dtype, and cannot take MLA's narrower value
    heads)."""
    if mask_kind not in ("causal", "full"):
        raise ValueError(mask_kind)
    return ops.flash_attention(
        q, k, v, causal=mask_kind == "causal", window=window, scale=scale
    )


def _flash_decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    new_len: int,
    *,
    scale: float,
) -> torch.Tensor:
    """GQA decode in the sequence-sharded layout: the grouped-query einsum
    consumes the cache as it is stored, never repeated to H heads.  Float32
    scores, slots at and past ``new_len`` masked."""
    b, s1, h, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, s1, hkv, h // hkv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale      # (B, kv, g, 1, S)
    valid = torch.arange(k_cache.shape[1], device=q.device) < new_len
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, s1, h, hd).to(q.dtype)


def _empty_cache_prefill(cache, s: int, use_chunked: bool) -> bool:
    """The empty-cache prefill route (module docstring) applies."""
    return cache is not None and cache.length == 0 and s > 1 and use_chunked


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


def _positions_for(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Expand (B, S) integer positions to M-RoPE's (B, S, 3) when needed."""
    if cfg.rope_variant == "mrope" and pos.ndim == 2:
        return pos[..., None].expand(*pos.shape, 3)
    return pos


def attention_forward(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,                   # (B, S, d)
    *,
    positions: torch.Tensor,           # (B, S), or (B, S, 3) for M-RoPE
    cache: KVCache | None = None,
    mask_kind: str = "causal",
    window: int | None = None,
    kv_source: torch.Tensor | None = None,   # cross-attention memory
    use_chunked: bool = False,
    ring: bool = False,                # sliding-window cache is a ring buffer
) -> tuple[torch.Tensor, KVCache | None]:
    """Self- or cross-attention with an optional decode cache.

    A cache's ``k``/``v`` tensors are written in place (slot writes into
    preallocated buffers); the returned :class:`KVCache` holds the same
    tensors and the new length.  For cross-attention (``kv_source``) with a
    cache, the cache holds the memory's projected k/v and is returned as
    it is; the k/v projections of ``kv_source``, which the JAX package
    computes there and then ignores, are skipped."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = common.split_heads(linear(p.wq, x), cfg.n_heads)
    cross_cached = cache is not None and kv_source is not None
    if not cross_cached:
        kv_in = x if kv_source is None else kv_source
        k = common.split_heads(linear(p.wk, kv_in), cfg.n_kv_heads)
        v = common.split_heads(linear(p.wv, kv_in), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, eps=cfg.norm_eps)
        if not cross_cached:
            k = rmsnorm(p.k_norm, k, eps=cfg.norm_eps)
    if cfg.rope_variant != "none" and kv_source is None:
        pos = _positions_for(cfg, positions)
        if cfg.rope_variant == "mrope":
            q = common.apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)
            k = common.apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = common.apply_rope(q, pos, cfg.rope_theta)
            k = common.apply_rope(k, pos, cfg.rope_theta)

    dev = x.device
    new_cache = None
    if (cache is not None and kv_source is None and not ring and s == 1
            and window is None):
        # one-token decode (module docstring): the cache as stored
        length = cache.length
        cache.k[:, length:length + 1] = k.to(cache.k.dtype)
        cache.v[:, length:length + 1] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, length + 1)
        out = _flash_decode_attention(q, cache.k, cache.v, length + 1,
                                      scale=1.0 / math.sqrt(hd))
    elif cache is not None and ring and kv_source is None:
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
    elif cross_cached:
        # cross-attention with a fixed memory: the cache holds projected k/v
        out = naive_attention(q, cache.k, cache.v, mask_kind="full")
        new_cache = cache
    elif cache is not None:
        # append this step's k/v at cache.length
        length = cache.length
        cache.k[:, length:length + s] = k.to(cache.k.dtype)
        cache.v[:, length:length + s] = v.to(cache.v.dtype)
        new_len = length + s
        new_cache = KVCache(cache.k, cache.v, new_len)
        if _empty_cache_prefill(cache, s, use_chunked):
            # the empty-cache prefill route (module docstring)
            out = chunked_attention(q, k, v, mask_kind="causal", window=window)
        else:
            out = naive_attention(
                q, cache.k, cache.v, mask_kind="causal",
                q_pos=length + torch.arange(s, device=dev),
                k_pos=torch.arange(cache.k.shape[1], device=dev),
                kv_valid_len=new_len, window=window,
            )
    else:
        attn = chunked_attention if use_chunked else naive_attention
        out = attn(q, k, v, mask_kind=mask_kind, window=window)

    return linear(p.wo, common.merge_heads(out)), new_cache


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV latent attention
# ----------------------------------------------------------------------


class MLACache(NamedTuple):
    """The decode cache holds the *compressed* latents.

    c_kv:   (B, S_max, kv_lora_rank)
    k_rope: (B, S_max, qk_rope_head_dim), already rotated
    length: tokens already cached (a host integer)
    """

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    length: int


class MLA(nn.Module):
    def __init__(self, w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo):
        super().__init__()
        self.w_dq, self.q_norm, self.w_uq = w_dq, q_norm, w_uq
        self.w_dkv, self.kv_norm = w_dkv, kv_norm
        self.w_uk, self.w_uv, self.wo = w_uk, w_uv, wo


def init_mla(gen, cfg: ModelConfig, *, device) -> MLA:
    m = cfg.mla or MLAConfig()
    d = cfg.d_model
    dt = common.dtype_of(cfg.dtype)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(d_in, d_out):
        return common.dense_init(gen, d_in, d_out, dtype=dt, device=device)

    w_dq = dense(d, m.q_lora_rank)
    w_uq = dense(m.q_lora_rank, cfg.n_heads * qk_head)
    w_dkv = dense(d, m.kv_lora_rank + m.qk_rope_head_dim)
    return MLA(
        w_dq, common.rmsnorm_init(m.q_lora_rank, device=device), w_uq,
        w_dkv, common.rmsnorm_init(m.kv_lora_rank, device=device),
        dense(m.kv_lora_rank, cfg.n_heads * m.qk_nope_head_dim),
        dense(m.kv_lora_rank, cfg.n_heads * m.v_head_dim),
        dense(cfg.n_heads * m.v_head_dim, d),
    )


def _mla_compress(cfg: ModelConfig, p: MLA, x: torch.Tensor):
    """x → (c_kv normalised, k_rope not yet rotated)."""
    m = cfg.mla or MLAConfig()
    ckv_full = linear(p.w_dkv, x)
    c_kv = rmsnorm(p.kv_norm, ckv_full[..., :m.kv_lora_rank], eps=cfg.norm_eps)
    return c_kv, ckv_full[..., m.kv_lora_rank:]


def _mla_queries(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla or MLAConfig()
    b, s, _ = x.shape
    q = linear(p.w_uq, rmsnorm(p.q_norm, linear(p.w_dq, x), eps=cfg.norm_eps))
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_rope = common.apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def mla_forward(
    cfg: ModelConfig,
    p: MLA,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: MLACache | None = None,
    use_chunked: bool = False,
) -> tuple[torch.Tensor, MLACache | None]:
    """MLA attention.

    Without a cache, and on the empty-cache prefill route (module
    docstring): the decompressed form, K = ``concat(k_nope, k_rope)``
    ``(B, S, H, qk_nope + qk_rope)`` and V ``(B, S, H, v_head_dim)``,
    through :func:`chunked_attention` (MLA's 192/128 heads at deepseek-v2
    widths) or :func:`naive_attention`; the route also writes the latents
    into the cache.  Otherwise, with a cache: the *absorbed* form, where
    queries are mapped into the latent space and attend the compressed
    cache directly (per-step cost scales with ``kv_lora_rank``)."""
    m = cfg.mla or MLAConfig()
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = _mla_queries(cfg, p, x, positions)
    c_kv, k_rope_raw = _mla_compress(cfg, p, x)
    dev = x.device
    length = 0 if cache is None else cache.length
    k_pos = length + torch.arange(s, device=dev)
    k_rope = common.apply_rope(k_rope_raw[:, :, None, :], k_pos[None, :], cfg.rope_theta)

    if cache is None or _empty_cache_prefill(cache, s, use_chunked):
        # --- decompressed form ------------------------------------------
        k_nope = linear(p.w_uk, c_kv).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim)
        val = linear(p.w_uv, c_kv).reshape(b, s, cfg.n_heads, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads, m.qk_rope_head_dim)], dim=-1)
        attn = chunked_attention if use_chunked else naive_attention
        out = attn(q, k, val, mask_kind="causal", scale=scale)
        out = out.reshape(b, s, cfg.n_heads * m.v_head_dim)
        new_cache = None
        if cache is not None:
            cache.c_kv[:, :s] = c_kv.to(cache.c_kv.dtype)
            cache.k_rope[:, :s] = k_rope[:, :, 0].to(cache.k_rope.dtype)
            new_cache = MLACache(cache.c_kv, cache.k_rope, s)
        return linear(p.wo, out), new_cache

    # --- absorbed form over the compressed cache --------------------------
    cache.c_kv[:, length:length + s] = c_kv.to(cache.c_kv.dtype)
    cache.k_rope[:, length:length + s] = k_rope[:, :, 0].to(cache.k_rope.dtype)
    new_len = length + s
    c_cache, r_cache = cache.c_kv, cache.k_rope
    # absorb W_UK into q: q_lat (B, S, H, kv_lora) = q_nope . W_UK(head)^T
    w_uk = p.w_uk.w.reshape(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    scores = (
        torch.einsum("bshr,bkr->bhsk", q_lat, c_cache)
        + torch.einsum("bshd,bkd->bhsk", q_rope, r_cache)
    ).to(torch.float32) * scale
    k_positions = torch.arange(c_cache.shape[1], device=dev)
    causal = k_positions[None, None, None, :] <= k_pos[None, None, :, None]
    valid = k_positions[None, None, None, :] < new_len
    scores = torch.where(causal & valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)   # cast before the latent product
    # attend in latent space, then decompress once per query token
    lat = torch.einsum("bhsk,bkr->bshr", probs, c_cache)
    w_uv = p.w_uv.w.reshape(m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", lat, w_uv).reshape(b, s, cfg.n_heads * m.v_head_dim)
    return linear(p.wo, out), MLACache(c_cache, r_cache, new_len)
