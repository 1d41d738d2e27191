"""Attention: the GQA layer (qk_norm, bias, RoPE or M-RoPE, cross-attention,
sliding-window ring caches), DeepSeek-V2 MLA (multi-head latent attention),
their decode caches, and three attention cores.

* :func:`naive_attention` materialises the ``(Sq, Sk)`` scores: short
  prompts without a cache (plain tensor code, as in the JAX package; on a
  mesh, on each rank's shard of whole heads, as B4).
* :func:`chunked_attention` is the long-prefill core: the flash-attention
  kernel through ``kernels.ops.flash_attention`` (on a CPU tensor, its
  plain version).  It takes value heads narrower than the query/key heads,
  as MLA's are.
* :func:`decode_attention` reads a cache as it is stored: every cached
  call but the empty-cache prefill route (a decode step or a prompt into a
  KV cache, the sliding-window ring, MLA's latent cache in the absorbed
  form, the cross-attention over a cached memory).

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
prompts of 6 144 tokens would need 78 GB of float32.

**Reading a cache** (:func:`decode_attention`) takes the grouped-query
einsum over the cache as it is stored (the JAX package's sequence-sharded
decode layout, which it takes when ``set_decode_flash_partitioning(True)``),
never repeating K/V to the query heads as ``naive_attention`` would, with
float32 products throughout: the same function as the reference's naive
attention over the cache.  On the card a plain KV cache is read by B6
(``kernels.decode_attention``), the same function in one kernel that reads
the cache once in its own dtype.  MLA's absorbed form is the same call with one
kv head, the latents: keys ``c_kv | k_rope``, values ``c_kv``.

**On a mesh** (DTensor parameters and a cache placed by
``runtime.sharding.state_shardings``) a cache is written only by the
ranks that own the positions written (``common.cache_write``,
``common.cache_write_ring``), and read where it lies: each rank scores its
own slots, and only the softmax statistics and the ``(B, Sq, H, Dv)``
output cross the "model" axis (the reference's docstring of its
sequence-sharded decode).  No call gathers a cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops, traced
from repro_torch.kernels.decode_attention import decode_attention_kernel, takes as b6_takes
from repro_torch.models import common
from repro_torch.models.common import linear, rmsnorm
from repro_torch.obs import trace

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
    "decode_attention",
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
    """Reference attention — materialises the (Sq, Sk) score matrix.

    DTensors run it on each rank's shard of whole sequences and whole heads
    (``kernels.ops.sharded_attention``, B4's layouts), never through
    DTensor's rules for its einsums."""
    trace.annotate("model.attention", route="naive")
    if isinstance(q, DTensor):
        def core(ql, kl, vl):
            return naive_attention(ql, kl, vl, mask_kind=mask_kind, q_pos=q_pos, k_pos=k_pos,
                                   kv_valid_len=kv_valid_len, window=window, scale=scale)
        return ops.sharded_attention(core, q, k, v)
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


DECODE_CHUNK = 8192   # cache slots scored at a time: bounds the float32 copies of k and v


def decode_attention(
    qs: list,               # query parts, each (B, Sq, H, D_i)
    ks: list,               # key parts, the caches as stored, each (B, S, Hkv, D_i)
    v: torch.Tensor,        # (B, S, Hkv, Dv): a cache, or one of ``ks`` itself
    *,
    q_pos: torch.Tensor,    # (Sq,) the queries' positions
    scale: float,
    k_pos=None,
    window: int | None = None,
) -> torch.Tensor:
    """Attention of a few queries over a cache as it is stored: every
    cached attention route (a KV cache, the ring, MLA's latent cache, the
    encoder-decoder's cross cache).  Returns (B, Sq, H, Dv) in the queries'
    dtype.

    A query's score against slot ``j`` is ``scale * sum_i q_i . k_i`` in
    float32, the grouped-query einsum never repeating K/V to the H query
    heads.  ``k_pos`` maps the slots' indices (a tensor) to their
    positions: a slot is attended where its position is at most the
    query's and, with ``window``, above ``q_pos - window``; ``None``
    attends every slot (a cross cache).  The slots are read
    ``DECODE_CHUNK`` at a time, each chunk converted to float32 once (a
    value that is one of the key parts, as MLA's latents are, with it),
    under an online softmax.

    DTensors run it on each rank's shard of the cache
    (:func:`_decode_attention_sharded`): the cache never moves.  A plain KV
    cache on the card takes B6 (:func:`_takes_b6`), which reads it once in
    its own dtype; every other call :func:`_decode_local`."""
    v_key = next((i for i, k in enumerate(ks) if k is v), None)
    if _takes_b6(qs, ks, v, v_key, k_pos, window):
        trace.annotate("model.attention", route="b6")
        return decode_attention_kernel(qs[0], ks[0], v, q_pos, scale=scale, window=window)
    trace.annotate("model.attention", route="decode")
    if isinstance(v, DTensor):
        return _decode_attention_sharded(qs, ks, v, v_key, q_pos=q_pos, scale=scale,
                                         k_pos=k_pos, window=window)
    return _decode_local(qs, ks, v, v_key, j0=0, q_pos=q_pos, scale=scale, k_pos=k_pos,
                         window=window, score_groups=(), slot_groups=())


def _takes_b6(qs, ks, v, v_key, k_pos, window) -> bool:
    """:func:`decode_attention` takes B6 (``kernels.decode_attention``):
    one key part, not the value, over a plain KV cache (``k_pos`` is
    :func:`_slot_positions`), on CUDA tensors that are neither DTensors nor
    the dry run's fakes, of the dtypes, widths, rows and window B6 takes
    (``kernels.decode_attention.takes``).  Reads only types, devices,
    dtypes and shapes: the ring, the cross cache, MLA's latents, a mesh and
    the CPU keep :func:`_decode_local`."""
    if len(ks) != 1 or v_key is not None or k_pos is not _slot_positions:
        return False
    q, k = qs[0], ks[0]
    if any(isinstance(t, DTensor) or traced.is_fake(t) or t.device.type != "cuda"
           for t in (q, k, v)):
        return False
    return b6_takes(q, k, v, window)


def _decode_local(qs, ks, v, v_key, *, j0: int, q_pos, scale, k_pos, window, score_groups,
                  slot_groups) -> torch.Tensor:
    """:func:`decode_attention` on slots ``j0 .. j0 + S - 1`` (a rank's
    shard); ``v_key``: the index of the key part that is the value, or
    None.  ``score_groups``: the process groups over which the keys' width
    is split (the scores are partial sums, reduced before the mask);
    ``slot_groups``: those over which the slots are (the row maxima, the
    exp-sums and the outputs are reduced: the flash-decoding combine)."""
    b, sq, h, _ = qs[0].shape
    s, hkv = ks[0].shape[1], ks[0].shape[2]
    f32 = torch.float32
    qg = [q.reshape(b, sq, hkv, h // hkv, q.shape[-1]).to(f32) for q in qs]
    qp = q_pos.to(ks[0].device)
    m = denom = out = None
    for c in range(0, max(s, 1), DECODE_CHUNK):
        kc = [k[:, c:c + DECODE_CHUNK].to(f32) for k in ks]
        vc = kc[v_key] if v_key is not None else v[:, c:c + DECODE_CHUNK].to(f32)
        scores = sum(torch.einsum("bqkgd,bskd->bkgqs", q, k)
                     for q, k in zip(qg, kc)) * scale          # (B, kv, g, Sq, chunk)
        for group in score_groups:
            scores = funcol.all_reduce(scores, "sum", group)
        if k_pos is not None:
            kp = k_pos(j0 + c + torch.arange(scores.shape[-1], device=qp.device))
            keep = kp[None, :] <= qp[:, None]
            if window is not None:
                keep = keep & (kp[None, :] > qp[:, None] - window)
            scores = torch.where(keep, scores, NEG_INF)
        m_c = scores.amax(dim=-1, keepdim=True)
        m_new = m_c if m is None else torch.maximum(m, m_c)
        p = torch.exp(scores - m_new)
        o_c = torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        if m is None:
            denom, out = p.sum(dim=-1, keepdim=True), o_c
        else:
            alpha = torch.exp(m - m_new)
            denom, out = denom * alpha + p.sum(dim=-1, keepdim=True), out * alpha + o_c
        m = m_new
    if slot_groups:
        m_all = m
        for group in slot_groups:
            m_all = funcol.all_reduce(m_all, "max", group)
        alpha = torch.exp(m - m_all)
        denom, out = denom * alpha, out * alpha
        for group in slot_groups:
            denom = funcol.all_reduce(denom, "sum", group)
            out = funcol.all_reduce(out, "sum", group)
    out = (out / denom).permute(0, 3, 1, 2, 4)                 # (B, Sq, kv, g, Dv)
    return out.reshape(b, sq, h, out.shape[-1]).to(qs[0].dtype)


def _decode_attention_sharded(qs, ks, v: DTensor, v_key, *, q_pos, scale, k_pos,
                              window) -> DTensor:
    """:func:`decode_attention` over a cache on a mesh, in one ``local_map``.

    The cache's layout decides, per mesh dimension of its (B, S, Hkv, D)
    view: the batch (``Shard(0)``) and the kv heads (``Shard(2)``, the
    query heads in the same contiguous blocks) are independent; the slots
    (``Shard(1)``: a KV cache's sequence, a ring's slots) take the
    flash-decoding combine, each rank scoring its own slots at their global
    positions and only the row maxima, the exp-sums and the (B, Sq, H, Dv)
    output crossing the ranks; a split key width (``Shard(3)``, the layout
    of ``cache_prefer="last"`` and of the cross cache) leaves each rank a
    partial score, summed before the softmax, and the output split the same
    way.  The queries are brought to that layout (whole over the slot
    axes: (B, Sq, H, D) is small); the key parts take the value's layout
    (the layouts ``state_shardings`` gives agree, so none moves)."""
    mesh = v.device_mesh
    layout = tuple(v.placements)
    q_layout = tuple(Replicate() if p == Shard(1) else p for p in layout)
    out_layout = q_layout
    split = 1
    for i, p in enumerate(layout):
        if isinstance(p, Shard) and p.dim == 2:
            split *= mesh.size(i)
    if qs[0].shape[2] % split or v.shape[2] % split:
        raise ValueError(f"decode_attention: {qs[0].shape[2]} query / {v.shape[2]} kv heads "
                         f"over {split} ranks")
    score_groups = tuple((mesh, i) for i, p in enumerate(layout) if p == Shard(3))
    slot_groups = tuple((mesh, i) for i, p in enumerate(layout) if p == Shard(1))
    j0 = common.local_range(v, 1)[0]
    nq = len(qs)

    vs = [] if v_key is not None else [v]   # a value that is a key part is passed once

    def local(*args):
        kl = list(args[nq:nq + len(ks)])
        return (_decode_local(list(args[:nq]), kl, args[-1] if vs else None, v_key, j0=j0,
                              q_pos=q_pos, scale=scale, k_pos=k_pos, window=window,
                              score_groups=score_groups, slot_groups=slot_groups),)

    qs = [q.redistribute(mesh, q_layout) for q in qs]
    ks = [k.redistribute(mesh, layout) for k in ks]
    return local_map(local, out_placements=(out_layout,),
                     in_placements=(q_layout,) * nq + (layout,) * (len(ks) + len(vs)),
                     device_mesh=mesh)(*qs, *ks, *vs)[0]


def _flash_decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    new_len: int,
    *,
    scale: float,
) -> torch.Tensor:
    """GQA decode in the sequence-sharded layout (the JAX package's
    ``_flash_decode_attention``): :func:`decode_attention` of one query at
    position ``new_len - 1`` over the slots below ``new_len``."""
    return decode_attention([q], [k_cache], v_cache, q_pos=_positions(new_len - 1, 1, q),
                            scale=scale, k_pos=_slot_positions)


def _slot_positions(j: torch.Tensor) -> torch.Tensor:
    """A KV cache's slot ``j`` holds position ``j``."""
    return j


def _fresh_positions(start: int):
    """Fresh k/v of positions ``start ..``: slot ``j`` holds ``start + j``."""
    return lambda j: start + j


def _ring_positions(new_len: int, w: int):
    """The positions of a ring of ``w`` slots after ``new_len`` tokens: slot
    ``j`` holds ``new_len - 1 - ((new_len - 1 - j) mod w)``; an unwritten
    slot maps negative and is pushed past every query, where the causal
    mask drops it."""
    def k_pos(j):
        p = new_len - 1 - torch.remainder(new_len - 1 - j, w)
        return torch.where(p >= 0, p, 2**30)
    return k_pos


def _positions(start: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """Positions ``start .. start + n - 1`` (a plain tensor on ``like``'s
    device)."""
    return start + torch.arange(n, device=like.device)


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

    scale = 1.0 / math.sqrt(hd)
    new_cache = None
    if cache is not None and ring and kv_source is None:
        # --- sliding-window ring cache -------------------------------
        # slot of absolute position p is p % w; after the write the ring
        # holds the last min(L, w) tokens.
        w = cache.k.shape[1]
        common.cache_write_ring(cache.k, k, cache.length)
        common.cache_write_ring(cache.v, v, cache.length)
        new_len = cache.length + s
        new_cache = KVCache(cache.k, cache.v, new_len)
        if s == 1:
            # decode: attend the ring at its slots' positions
            out = decode_attention([q], [cache.k], cache.v, q_pos=_positions(cache.length, 1, q),
                                   scale=scale, k_pos=_ring_positions(new_len, w), window=w)
        else:
            # prefill: exact windowed attention over the fresh k/v (early
            # tokens must still see their full in-window history, which the
            # ring has overwritten); a short one reads them as a cache of
            # their own
            if use_chunked:
                out = chunked_attention(q, k, v, mask_kind="causal", window=w)
            else:
                out = decode_attention([q], [k], v, q_pos=_positions(cache.length, s, q),
                                       scale=scale, k_pos=_fresh_positions(cache.length),
                                       window=w)
    elif cross_cached:
        # cross-attention with a fixed memory: the cache holds projected k/v
        out = decode_attention([q], [cache.k], cache.v, q_pos=_positions(0, s, q), scale=scale)
        new_cache = cache
    elif cache is not None:
        # append this step's k/v at cache.length
        length = cache.length
        common.cache_write(cache.k, k, length)
        common.cache_write(cache.v, v, length)
        new_len = length + s
        new_cache = KVCache(cache.k, cache.v, new_len)
        if _empty_cache_prefill(cache, s, use_chunked):
            # the empty-cache prefill route (module docstring)
            out = chunked_attention(q, k, v, mask_kind="causal", window=window)
        else:
            # every other cached call: the cache as it is stored (module
            # docstring)
            out = decode_attention([q], [cache.k], cache.v, q_pos=_positions(length, s, q),
                                   scale=scale, k_pos=_slot_positions, window=window)
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
            common.cache_write(cache.c_kv, c_kv, 0)
            common.cache_write(cache.k_rope, k_rope[:, :, 0], 0)
            new_cache = MLACache(cache.c_kv, cache.k_rope, s)
        return linear(p.wo, out), new_cache

    # --- absorbed form over the compressed cache --------------------------
    common.cache_write(cache.c_kv, c_kv, length)
    common.cache_write(cache.k_rope, k_rope[:, :, 0], length)
    new_len = length + s
    c_cache, r_cache = cache.c_kv, cache.k_rope
    # absorb W_UK into q: q_lat (B, S, H, kv_lora) = q_nope . W_UK(head)^T;
    # the latents are one kv head that keys (c_kv | k_rope) and values
    # (c_kv) share
    w_uk = p.w_uk.w.reshape(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    c_heads = c_cache.unsqueeze(2)
    lat = decode_attention([q_lat, q_rope], [c_heads, r_cache.unsqueeze(2)], c_heads,
                           q_pos=k_pos, scale=scale, k_pos=_slot_positions)
    # decompress once per query token
    w_uv = p.w_uv.w.reshape(m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", lat, w_uv).reshape(b, s, cfg.n_heads * m.v_head_dim)
    return linear(p.wo, out), MLACache(c_cache, r_cache, new_len)
