"""Model assembly for every architecture family.

:class:`Model` is the facade the serving engine drives:

* ``init(seed)``                    — the parameters, an ``nn.Module``
* ``init_cache(batch, max_len)``    — the decode cache, a dict of tensors
* ``prefill(params, batch, cache)`` — run the prompt, fill the cache
* ``decode_step(params, tokens, cache)`` — one token with the cache
* ``train_loss(params, batch)``      — the training loss and its parts,
  differentiable with respect to the parameters (``Model.remat``,
  ``Model.vocab_chunk`` as in the JAX package)

The JAX package scans over stacked layer parameters; here the layers are a
Python loop over ``nn.Module``\\ s, and a cache is a dict of preallocated
tensors (keyed as the JAX package keys them: ``main/k``, ``dense0/c_kv``,
``self_k``, ``cross_k``, ``mlstm``, ``mamba``, ...) that every call writes
in place.  The families:

* dense / MoE / VLM: a decoder of GQA (or MLA) attention and SwiGLU (or
  MoE) blocks, ``first_dense_layers`` of them with a dense FFN
  (``dense0``); VLM with M-RoPE and the vision frontend's patch embeddings
  spliced over the first token rows.  A prefill longer than 4096 tokens
  runs the flash-attention kernel once per attention layer.
* encoder-decoder (seamless): an encoder over the audio frontend's frame
  embeddings, and a decoder with self- and cross-attention whose cross k/v
  are projected once at prefill.  No kernel (the JAX package runs
  ``naive_attention`` throughout).
* hybrid (zamba2): a Mamba2 backbone with ONE set of attention + SwiGLU
  weights invoked after every ``shared_attn_every`` Mamba2 layers; every
  prefill runs the Mamba2 scan kernel once per Mamba2 layer, and a prefill
  longer than 4096 tokens the flash-attention kernel once per invocation.
* SSM (xlstm): groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM
  block, run one token at a time.  No kernel.

Frontends are stubs, as in the JAX package: precomputed patch or frame
embeddings arrive in the batch.

Serving opens trace spans on the active tracer
(:func:`repro_torch.obs.trace.span`; nothing without one):
``model.prefill`` / ``model.decode_step`` around a call, ``model.embed``,
``model.logits`` (the final norm and the head), and in the decoder-only and
hybrid families one ``model.attention`` (``layer`` or ``group``, and the
``route`` that the attention core it calls sets: ``b4``, ``chunked``,
``naive`` or ``decode``) and ``model.ffn`` a block and one ``model.mamba``
(``group``, ``layer``) a Mamba2 layer.

Training runs the cache-free paths under autograd.  With ``remat`` each
layer body (the JAX package's ``jax.checkpoint`` unit: a decoder, encoder
or cross block, a zamba2 group of Mamba2 layers and the shared block, an
xLSTM group) runs under ``torch.utils.checkpoint(use_reentrant=False)``:
only its input is kept, and its forward runs again in the backward (the
kernels of a body launch twice a step).  The JAX package saves the matrix
products' outputs too (``dots_with_no_batch_dims_saveable``); the numbers
are the same either way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mcop_phase import require_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common, ffn, ssm
from repro_torch.models.common import linear, rmsnorm
from repro_torch.obs import trace

__all__ = ["Model", "DecoderLM", "EncDecLM", "ZambaLM", "XLSTMLM", "build_model",
           "ZAMBA_WINDOW"]

ZAMBA_WINDOW = 4096  # shared-attn sliding window: keeps long contexts sub-quadratic
CHUNKED_ABOVE = 4096  # a prefill longer than this takes the chunked (flash) core


# ======================================================================
# Shared helpers
# ======================================================================


def _sinusoidal_positions(seq_len: int, d: int, offset: int = 0, *, device) -> torch.Tensor:
    """(S, d) float32 sinusoidal encodings of positions offset .. offset+S-1."""
    f32 = torch.float32
    pos = (torch.arange(seq_len, device=device) + offset).to(f32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=f32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros((seq_len, d), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _embed_tokens(cfg: ModelConfig, params: nn.Module, batch: dict) -> torch.Tensor:
    """Token embeddings; for the vision frontend, ``batch["patch_embeds"]``
    (Bp, P, d) overwrites rows ``0 .. P-1`` of the first Bp sequences (after
    the serving engine's left padding), as the JAX package's
    ``dynamic_update_slice`` at (0, 0, 0) does.  That needs ``P <= S`` and
    ``Bp <= B``: elsewhere the JAX package fails, and this raises
    ``ValueError``."""
    dt = common.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    with trace.span("model.embed"):
        x = common.layout_of(common.embed_lookup(params.embed.embedding, tokens).to(dt), tokens)
    if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
        patches = batch["patch_embeds"]
        pb, pp, pd = patches.shape
        b, s, d = x.shape
        if pb > b or pp > s or pd != d:
            raise ValueError(f"patch embeddings {tuple(patches.shape)} do not fit in the "
                             f"token embeddings {tuple(x.shape)}")
        if isinstance(x, DTensor) and pb == b:
            # out of place: DTensor's backward of a slice written in place
            # into a batch-sharded tensor has no rule
            return common.layout_of(torch.cat([patches.to(dt), x[:, pp:]], dim=1), tokens)
        x[:pb, :pp] = patches.to(dt)
    return x


def _default_positions(cfg: ModelConfig, b: int, s: int, batch: dict, *, device):
    if cfg.rope_variant == "mrope":
        if "positions" in batch:
            return batch["positions"]
        return torch.arange(s, device=device)[None, :, None].expand(b, s, 3)
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _lm_logits(cfg: ModelConfig, params: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return linear(params.lm_head, rmsnorm(params.final_norm, x, eps=cfg.norm_eps))


def _serving_logits(cfg: ModelConfig, params: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The (B, V) logits of the last position of ``x`` (B, 1, d).  On a
    mesh they leave in the layout of the serving cell's outputs
    (``runtime.sharding.input_shardings``): the batch as the residual
    stream's (over the data axes, when they divide it), whole over the
    others, where the LM head gives the vocabulary split over "model"."""
    with trace.span("model.logits"):
        logits = _lm_logits(cfg, params, x)[:, 0]
        if isinstance(logits, DTensor):
            pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in x.placements)
            logits = logits.redistribute(logits.device_mesh, pl)
    return logits


def _stacks_whole(cache: dict, n_stacked: int = 1):
    """``cache`` with every DTensor leaf that is split along one of its
    stacked layer axes (two for the ``mamba`` and ``mlstm`` states, one
    elsewhere) brought to a layout where those axes are whole, so that each
    layer's slice is a view on every rank (``common.cache_layer``); and
    ``{id(working leaf): (working leaf, leaf)}`` for
    :func:`_stacks_written_back`.

    ``state_shardings`` splits over the data axes the first axis equal to
    the batch size, as the reference does: at batch 2, zamba2's Mamba2
    states ``(groups, every = 2, B, ...)`` have ``every`` over "data" and
    the batch whole.  Such a leaf moves whole over those axes for the call
    (a state: the KV caches' stacked axis is the layers'), and is written
    back into its own layout after it."""
    work, back = {}, {}
    for key, leaf in cache.items():
        if isinstance(leaf, dict):
            work[key], sub = _stacks_whole(leaf, 2 if key in ("mamba", "mlstm") else 1)
            back.update(sub)
            continue
        pl = getattr(leaf, "placements", ())
        if any(isinstance(p, Shard) and p.dim < n_stacked for p in pl):
            whole = tuple(Replicate() if isinstance(p, Shard) and p.dim < n_stacked else p
                          for p in pl)
            work[key] = leaf.redistribute(leaf.device_mesh, whole)
            back[id(work[key])] = (work[key], leaf)
        else:
            work[key] = leaf
    return (work, back) if back else (cache, back)


def _stacks_written_back(cache: dict, back: dict) -> dict:
    """``cache`` (a step's result on the working leaves of
    :func:`_stacks_whole`) with each working leaf written into its own
    leaf, which takes its place."""
    if not back:
        return cache
    out = {}
    for key, leaf in cache.items():
        if isinstance(leaf, dict):
            out[key] = _stacks_written_back(leaf, back)
        elif id(leaf) in back:
            work, own = back[id(leaf)]
            common.cache_set(own, work)
            out[key] = own
        else:
            out[key] = leaf
    return out


def _body(fn, remat: bool):
    """``fn`` as a layer body: under ``torch.utils.checkpoint`` with
    ``remat`` (its activations recomputed in the backward), else as it is."""
    if not remat:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ======================================================================
# Dense / MoE / VLM decoder-only family
# ======================================================================


class DecoderBlock(nn.Module):
    """``attn`` GQA or MLA; ``ffn`` (dense SwiGLU) or ``moe``, the other None."""

    def __init__(self, ln1, attn, ln2, ffn_=None, moe=None):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        self.ffn, self.moe = ffn_, moe


class DecoderLM(nn.Module):
    """``blocks[i]`` the main stack; ``dense0[i]`` the leading dense-FFN
    blocks of an MoE model (``first_dense_layers``), or None."""

    def __init__(self, embed, blocks, final_norm, lm_head, dense0=None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.dense0 = None if dense0 is None else nn.ModuleList(dense0)


def _init_decoder_block(gen, cfg: ModelConfig, *, moe_layer: bool, device) -> DecoderBlock:
    dt = common.dtype_of(cfg.dtype)
    if cfg.attn_kind == "mla":
        attn = attn_lib.init_mla(gen, cfg, device=device)
    else:
        attn = attn_lib.init_attention(gen, cfg, device=device)
    ln1 = common.rmsnorm_init(cfg.d_model, device=device)
    ln2 = common.rmsnorm_init(cfg.d_model, device=device)
    if moe_layer:
        return DecoderBlock(ln1, attn, ln2, moe=ffn.init_moe(gen, cfg, device=device))
    d_ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.first_dense_layers) else cfg.d_ff
    return DecoderBlock(ln1, attn, ln2,
                        ffn_=ffn.init_swiglu(gen, cfg.d_model, d_ff, dtype=dt, device=device))


def _init_decoder_lm(gen, cfg: ModelConfig, *, device) -> DecoderLM:
    dt = common.dtype_of(cfg.dtype)
    n_dense0 = cfg.moe.first_dense_layers if cfg.moe else 0
    embed = common.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt, device=device)
    blocks = [_init_decoder_block(gen, cfg, moe_layer=cfg.moe is not None, device=device)
              for _ in range(cfg.n_layers - n_dense0)]
    lm_head = common.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dt, device=device)
    dense0 = [_init_decoder_block(gen, cfg, moe_layer=False, device=device)
              for _ in range(n_dense0)] or None
    return DecoderLM(embed, blocks, common.rmsnorm_init(cfg.d_model, device=device),
                     lm_head, dense0)


def _decoder_block(cfg: ModelConfig, p: DecoderBlock, x: torch.Tensor, *,
                   positions: torch.Tensor, cache: dict | None, length: int,
                   use_chunked: bool, layer: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss); the cache slice's tensors are written in place.
    ``layer``: the block's index in the stack, for its trace spans."""
    with trace.span("model.attention", layer=layer):
        h = rmsnorm(p.ln1, x, eps=cfg.norm_eps)
        if cfg.attn_kind == "mla":
            mcache = (None if cache is None
                      else attn_lib.MLACache(cache["c_kv"], cache["k_rope"], length))
            a, _ = attn_lib.mla_forward(cfg, p.attn, h, positions=positions, cache=mcache,
                                        use_chunked=use_chunked)
        else:
            kcache = None if cache is None else attn_lib.KVCache(cache["k"], cache["v"], length)
            a, _ = attn_lib.attention_forward(cfg, p.attn, h, positions=positions,
                                              cache=kcache, use_chunked=use_chunked)
        x = common.layout_of(x + a, x)
    with trace.span("model.ffn", layer=layer):
        h = rmsnorm(p.ln2, x, eps=cfg.norm_eps)
        if p.moe is not None:
            f, aux = ffn.moe_forward(cfg, p.moe, h)
        else:
            f, aux = ffn.swiglu_forward(p.ffn, h), torch.zeros((), device=x.device)
        x = common.layout_of(x + f, x)
    return x, aux


def _run_decoder_stack(cfg: ModelConfig, params: DecoderLM, x: torch.Tensor, *,
                       positions: torch.Tensor, cache: dict | None, use_chunked: bool,
                       remat: bool = False):
    """x through the ``dense0`` blocks, then the main blocks.  Returns (x,
    cache with the new length or None, summed aux loss)."""
    aux = torch.zeros((), device=x.device)
    length = 0 if cache is None else cache["length"]
    keys = ("c_kv", "k_rope") if cfg.attn_kind == "mla" else ("k", "v")
    layer = 0
    for prefix, blocks in (("dense0/", params.dense0), ("main/", params.blocks)):
        for i, p in enumerate(blocks or ()):
            c = None if cache is None else {k: common.cache_layer(cache[prefix + k], i)
                                            for k in keys}

            def block(x_, p=p, c=c, layer=layer):
                return _decoder_block(cfg, p, x_, positions=positions, cache=c,
                                      length=length, use_chunked=use_chunked, layer=layer)

            x, a = _body(block, remat and cache is None)(x)
            aux = aux + a
            layer += 1
    if cache is None:
        return x, None, aux
    cache["length"] = length + x.shape[1]
    return x, cache, aux


# ======================================================================
# Encoder-decoder family (seamless backbone)
# ======================================================================


class EncoderBlock(nn.Module):
    def __init__(self, ln1, attn, ln2, ffn_):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.ffn = ln1, attn, ln2, ffn_


class CrossBlock(nn.Module):
    def __init__(self, ln1, self_attn, ln_x, cross_attn, ln2, ffn_):
        super().__init__()
        self.ln1, self.self_attn = ln1, self_attn
        self.ln_x, self.cross_attn = ln_x, cross_attn
        self.ln2, self.ffn = ln2, ffn_


class EncDecLM(nn.Module):
    def __init__(self, embed, enc_blocks, enc_norm, dec_blocks, final_norm, lm_head):
        super().__init__()
        self.embed = embed
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


def _init_encdec(gen, cfg: ModelConfig, *, device) -> EncDecLM:
    dt = common.dtype_of(cfg.dtype)
    d = cfg.d_model

    def norm():
        return common.rmsnorm_init(d, device=device)

    def swiglu():
        return ffn.init_swiglu(gen, d, cfg.d_ff, dtype=dt, device=device)

    def attn():
        return attn_lib.init_attention(gen, cfg, device=device)

    embed = common.embed_init(gen, cfg.vocab_size, d, dtype=dt, device=device)
    enc = [EncoderBlock(norm(), attn(), norm(), swiglu()) for _ in range(cfg.encoder_layers)]
    dec = [CrossBlock(norm(), attn(), norm(), attn(), norm(), swiglu())
           for _ in range(cfg.n_layers)]
    lm_head = common.dense_init(gen, d, cfg.vocab_size, dtype=dt, device=device)
    return EncDecLM(embed, enc, norm(), dec, norm(), lm_head)


def _run_encoder(cfg: ModelConfig, params: EncDecLM, src: torch.Tensor, *,
                 remat: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings (B, S, d), cast to the model's dtype."""
    src = src.to(common.dtype_of(cfg.dtype))
    b, s, d = src.shape
    pe = _sinusoidal_positions(s, d, device=src.device).to(src.dtype)[None]
    x = src + common.replicated_like(pe, src)
    pos = torch.arange(s, device=src.device)[None, :].expand(b, s)
    for p in params.enc_blocks:

        def block(x, p=p):
            h = rmsnorm(p.ln1, x, eps=cfg.norm_eps)
            a, _ = attn_lib.attention_forward(cfg, p.attn, h, positions=pos, mask_kind="full")
            x = common.layout_of(x + a, x)
            h = rmsnorm(p.ln2, x, eps=cfg.norm_eps)
            return common.layout_of(x + ffn.swiglu_forward(p.ffn, h), x)

        x = _body(block, remat)(x)
    return rmsnorm(params.enc_norm, x, eps=cfg.norm_eps)


def _run_decoder_encdec(cfg: ModelConfig, params: EncDecLM, x: torch.Tensor,
                        memory: torch.Tensor | None, cache: dict | None, *,
                        remat: bool = False):
    """The decoder: against ``memory`` without a cache, against the cache's
    projected cross k/v with one.  Decoder positions are ``0 .. S-1`` at
    every call, as in the JAX package; the sinusoidal offset follows the
    cache's length."""
    b, s, d = x.shape
    dev = x.device
    length = 0 if cache is None else cache["length"]
    pe = _sinusoidal_positions(s, d, offset=length, device=dev).to(x.dtype)[None]
    x = x + common.replicated_like(pe, x)
    pos = torch.arange(s, device=dev)[None, :].expand(b, s)
    for i, p in enumerate(params.dec_blocks):

        def block(x, memory, i=i, p=p):
            h = rmsnorm(p.ln1, x, eps=cfg.norm_eps)
            self_c = (None if cache is None
                      else attn_lib.KVCache(common.cache_layer(cache["self_k"], i),
                                            common.cache_layer(cache["self_v"], i), length))
            a, _ = attn_lib.attention_forward(cfg, p.self_attn, h, positions=pos, cache=self_c)
            x = common.layout_of(x + a, x)
            h = rmsnorm(p.ln_x, x, eps=cfg.norm_eps)
            if cache is not None:
                cross_c = attn_lib.KVCache(common.cache_layer(cache["cross_k"], i),
                                           common.cache_layer(cache["cross_v"], i), 0)
                a, _ = attn_lib.attention_forward(cfg, p.cross_attn, h, positions=pos,
                                                  cache=cross_c, kv_source=h)
            else:
                a, _ = attn_lib.attention_forward(cfg, p.cross_attn, h, positions=pos,
                                                  kv_source=memory, mask_kind="full")
            x = common.layout_of(x + a, x)
            h = rmsnorm(p.ln2, x, eps=cfg.norm_eps)
            return common.layout_of(x + ffn.swiglu_forward(p.ffn, h), x)

        x = _body(block, remat and cache is None)(x, memory)
    if cache is None:
        return x, None
    cache["length"] = length + s
    return x, cache


# ======================================================================
# Hybrid (zamba2) — mamba backbone + weight-shared attention block
# ======================================================================


class ZambaLM(nn.Module):
    """Parameters of the hybrid model.  ``mamba[g][i]`` is the i-th Mamba2
    layer of group g; ``shared_ln[g]``/``shared_ln2[g]`` are the pre-norm
    scales of the shared block's g-th invocation."""

    def __init__(self, embed, mamba, shared_attn, shared_ffn, shared_ln, shared_ln2,
                 final_norm, lm_head):
        super().__init__()
        self.embed = embed
        self.mamba = nn.ModuleList(nn.ModuleList(group) for group in mamba)
        self.shared_attn = shared_attn
        self.shared_ffn = shared_ffn
        self.shared_ln = common.param(shared_ln)    # (groups, d) float32
        self.shared_ln2 = common.param(shared_ln2)
        self.final_norm = final_norm
        self.lm_head = lm_head


def _init_zamba(gen, cfg: ModelConfig, *, device) -> ZambaLM:
    dt = common.dtype_of(cfg.dtype)
    every = cfg.shared_attn_every
    groups = cfg.n_layers // every
    ones = torch.ones((groups, cfg.d_model), dtype=torch.float32, device=device)
    return ZambaLM(
        embed=common.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt, device=device),
        mamba=[[ssm.init_mamba2(gen, cfg, device=device) for _ in range(every)]
               for _ in range(groups)],
        shared_attn=attn_lib.init_attention(gen, cfg, device=device),
        shared_ffn=ffn.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype=dt, device=device),
        shared_ln=ones,
        shared_ln2=ones.clone(),
        final_norm=common.rmsnorm_init(cfg.d_model, device=device),
        lm_head=common.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dt, device=device),
    )


def _run_zamba(
    cfg: ModelConfig,
    params: ZambaLM,
    x: torch.Tensor,
    cache: dict | None,
    *,
    decode: bool,
    remat: bool = False,
):
    """The layer stack.  With a cache, its tensors are updated in place and
    the returned dict holds them with the new length."""
    b, s, _ = x.shape
    length = cache["length"] if cache is not None else 0
    positions = (length + torch.arange(s, device=x.device))[None, :].expand(b, s)
    for g, group in enumerate(params.mamba):

        def body(x_, g=g, group=group):
            return _zamba_group(cfg, params, g, group, x_, positions, cache, length, decode)

        x = _body(body, remat and cache is None)(x)
    if cache is None:
        return x, None
    return x, {"mamba": cache["mamba"], "attn_k": cache["attn_k"],
               "attn_v": cache["attn_v"], "length": length + s}


def _zamba_group(cfg: ModelConfig, params: ZambaLM, g: int, group, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None, length: int,
                 decode: bool) -> torch.Tensor:
    """Group ``g``: its ``every`` Mamba2 layers, then the shared attention +
    FFN block with the group's norm scales."""
    s = x.shape[1]
    for i, p_m in enumerate(group):
        with trace.span("model.mamba", group=g, layer=i):
            st = None
            if cache is not None:
                st = ssm.MambaState(common.cache_layer(cache["mamba"]["h"], g, i),
                                    common.cache_layer(cache["mamba"]["conv"], g, i))
            if decode:
                y, new_st = ssm.mamba2_step(cfg, p_m, x, st)
            else:
                y, new_st = ssm.mamba2_forward(cfg, p_m, x, st)
            x = common.layout_of(x + y, x)
            if cache is not None:
                common.cache_set(st.h, new_st.h)
                common.cache_set(st.conv, new_st.conv)

    with trace.span("model.attention", group=g):
        h = rmsnorm(params.shared_ln[g], x, eps=cfg.norm_eps)
        if cache is not None:
            kv = attn_lib.KVCache(common.cache_layer(cache["attn_k"], g),
                                  common.cache_layer(cache["attn_v"], g), length)
            a, _ = attn_lib.attention_forward(
                cfg, params.shared_attn, h, positions=positions, cache=kv,
                window=ZAMBA_WINDOW, ring=True, use_chunked=s > 4096,
            )
        else:
            a, _ = attn_lib.attention_forward(
                cfg, params.shared_attn, h, positions=positions,
                window=ZAMBA_WINDOW, use_chunked=s > 4096,
            )
        x = common.layout_of(x + a, x)
    with trace.span("model.ffn", group=g):
        h = rmsnorm(params.shared_ln2[g], x, eps=cfg.norm_eps)
        x = common.layout_of(x + ffn.swiglu_forward(params.shared_ffn, h), x)
    return x


# ======================================================================
# SSM (xlstm) — groups of (slstm_every − 1) mLSTM + 1 sLSTM
# ======================================================================


class XLSTMLM(nn.Module):
    """``mlstm[g][i]`` the i-th mLSTM block of group g and ``slstm[g]`` its
    sLSTM block; ``ln_m`` (groups, every-1, d) and ``ln_s`` (groups, d) their
    pre-norm scales."""

    def __init__(self, embed, mlstm, slstm, ln_m, ln_s, final_norm, lm_head):
        super().__init__()
        self.embed = embed
        self.mlstm = nn.ModuleList(nn.ModuleList(group) for group in mlstm)
        self.slstm = nn.ModuleList(slstm)
        self.ln_m = common.param(ln_m)
        self.ln_s = common.param(ln_s)
        self.final_norm = final_norm
        self.lm_head = lm_head


def _init_xlstm(gen, cfg: ModelConfig, *, device) -> XLSTMLM:
    dt = common.dtype_of(cfg.dtype)
    every = cfg.slstm_every
    groups = cfg.n_layers // every
    f32 = torch.float32
    embed = common.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt, device=device)
    mlstm = [[ssm.init_mlstm(gen, cfg, device=device) for _ in range(every - 1)]
             for _ in range(groups)]
    slstm = [ssm.init_slstm(gen, cfg, device=device) for _ in range(groups)]
    lm_head = common.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dt, device=device)
    return XLSTMLM(
        embed, mlstm, slstm,
        torch.ones((groups, every - 1, cfg.d_model), dtype=f32, device=device),
        torch.ones((groups, cfg.d_model), dtype=f32, device=device),
        common.rmsnorm_init(cfg.d_model, device=device), lm_head,
    )


def _run_xlstm(cfg: ModelConfig, params: XLSTMLM, x: torch.Tensor, cache: dict | None,
               *, decode: bool, remat: bool = False):
    """The block stack; a cache's state tensors are updated in place."""
    for g, group in enumerate(params.mlstm):

        def body(x_, g=g, group=group):
            return _xlstm_group(cfg, params, g, group, x_, cache, decode)

        x = _body(body, remat and cache is None)(x)
    if cache is None:
        return x, None
    cache["length"] = cache["length"] + x.shape[1]
    return x, cache


def _xlstm_group(cfg: ModelConfig, params: XLSTMLM, g: int, group, x: torch.Tensor,
                 cache: dict | None, decode: bool) -> torch.Tensor:
    """Group ``g``: its mLSTM blocks, then its sLSTM block."""
    fields = ssm.XLSTMState._fields
    for i, p in enumerate(group):
        h = rmsnorm(params.ln_m[g, i], x, eps=cfg.norm_eps)
        st = (None if cache is None
              else ssm.XLSTMState(*(common.cache_layer(cache["mlstm"][f], g, i)
                                    for f in fields)))
        step = ssm.mlstm_step if decode else ssm.mlstm_forward
        y, new = step(cfg, p, h, st)
        x = common.layout_of(x + y, x)
        if cache is not None:
            for dst, src in zip(st, new):
                common.cache_set(dst, src)
    h = rmsnorm(params.ln_s[g], x, eps=cfg.norm_eps)
    st = (None if cache is None
          else ssm.XLSTMState(*(common.cache_layer(cache["slstm"][f], g) for f in fields)))
    step = ssm.slstm_step if decode else ssm.slstm_forward
    y, new = step(cfg, params.slstm[g], h, st)
    if cache is not None:
        for dst, src in zip(st, new):
            common.cache_set(dst, src)
    return common.layout_of(x + y, x)


# ======================================================================
# Model facade
# ======================================================================

FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "ssm")


@dataclasses.dataclass
class Model:
    """``device`` is where parameters, caches and compute live (default the
    GPU; without one every method raises ``KernelError``).  ``remat`` and
    ``vocab_chunk`` shape ``train_loss`` as in the JAX package: activation
    checkpointing of every layer body, and a cross-entropy over vocab
    chunks of that many columns that never holds the (B, S, V) logits
    (0: the whole vocabulary at once)."""

    cfg: ModelConfig
    device: str | torch.device = "cuda"
    remat: bool = True
    vocab_chunk: int = 0

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {self.cfg.family!r}")

    def _device(self) -> torch.device:
        return require_device(self.device)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> nn.Module:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
        the model's device (on ``meta``: shapes only, nothing drawn)."""
        cfg = self.cfg
        dev = self._device()
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        init = {"dense": _init_decoder_lm, "moe": _init_decoder_lm, "vlm": _init_decoder_lm,
                "encdec": _init_encdec, "hybrid": _init_zamba, "ssm": _init_xlstm}
        return init[cfg.family](gen, cfg, device=dev)

    # ------------------------------------------------------------------
    def train_loss(self, params: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss of ``batch`` (``tokens`` and ``labels`` (B, S),
        and the frontends' embeddings): mean token NLL over the labels that
        are not -100, plus the MoE load-balancing loss.  Returns ``(nll +
        aux, {"nll": nll, "aux": aux})``, float32 scalars differentiable
        with respect to ``params``.  The JAX package's routes: a sequence
        longer than 4096 tokens takes the chunked attention core (the
        flash-attention kernel on the GPU) in the decoder-only families and
        zamba2's shared block."""
        cfg = self.cfg
        remat = self.remat
        if cfg.family in ("dense", "moe", "vlm"):
            x = _embed_tokens(cfg, params, batch)
            b, s = batch["tokens"].shape
            pos = _default_positions(cfg, b, s, batch, device=x.device)
            x, _, aux = _run_decoder_stack(cfg, params, x, positions=pos, cache=None,
                                           use_chunked=s > CHUNKED_ABOVE, remat=remat)
        elif cfg.family == "encdec":
            memory = _run_encoder(cfg, params, batch["frame_embeds"], remat=remat)
            tokens = batch["tokens"]
            x = common.layout_of(
                common.embed_lookup(params.embed.embedding, tokens).to(memory.dtype), tokens)
            x, _ = _run_decoder_encdec(cfg, params, x, memory, None, remat=remat)
            aux = torch.zeros((), device=x.device)
        elif cfg.family == "hybrid":
            x = _embed_tokens(cfg, params, batch)
            x, _ = _run_zamba(cfg, params, x, None, decode=False, remat=remat)
            aux = torch.zeros((), device=x.device)
        else:
            x = _embed_tokens(cfg, params, batch)
            x, _ = _run_xlstm(cfg, params, x, None, decode=False, remat=remat)
            aux = torch.zeros((), device=x.device)
        if self.vocab_chunk:
            h = rmsnorm(params.final_norm, x, eps=cfg.norm_eps)
            nll = common.softmax_cross_entropy_chunked(h, params.lm_head, batch["labels"],
                                                       chunk=self.vocab_chunk)
        else:
            nll = common.softmax_cross_entropy(_lm_logits(cfg, params, x), batch["labels"])
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dev = self._device()
        dt = common.dtype_of(cfg.dtype)
        hd = cfg.resolved_head_dim
        f32 = torch.float32

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.family in ("dense", "moe", "vlm"):
            n_dense0 = cfg.moe.first_dense_layers if cfg.moe else 0
            cache: dict = {"length": 0}
            for prefix, n in (("main/", cfg.n_layers - n_dense0), ("dense0/", n_dense0)):
                if not n:
                    continue
                if cfg.attn_kind == "mla":
                    cache[prefix + "c_kv"] = zeros(n, batch_size, max_len, cfg.mla.kv_lora_rank)
                    cache[prefix + "k_rope"] = zeros(n, batch_size, max_len,
                                                     cfg.mla.qk_rope_head_dim)
                else:
                    cache[prefix + "k"] = zeros(n, batch_size, max_len, cfg.n_kv_heads, hd)
                    cache[prefix + "v"] = zeros(n, batch_size, max_len, cfg.n_kv_heads, hd)
            return cache
        if cfg.family == "encdec":
            n = cfg.n_layers
            return {
                "self_k": zeros(n, batch_size, max_len, cfg.n_kv_heads, hd),
                "self_v": zeros(n, batch_size, max_len, cfg.n_kv_heads, hd),
                # the memory's projected k/v, made at prefill
                "cross_k": zeros(n, batch_size, 1, cfg.n_kv_heads, hd),
                "cross_v": zeros(n, batch_size, 1, cfg.n_kv_heads, hd),
                "length": 0,
            }
        if cfg.family == "hybrid":
            every = cfg.shared_attn_every
            groups = cfg.n_layers // every
            d_inner = cfg.ssm_expand * cfg.d_model
            n_heads_m = d_inner // cfg.mamba_headdim
            w = min(ZAMBA_WINDOW, max_len)
            return {
                "mamba": {
                    "h": zeros(groups, every, batch_size, n_heads_m, cfg.mamba_headdim,
                               cfg.ssm_state, dtype=f32),
                    "conv": zeros(groups, every, batch_size, cfg.ssm_conv - 1,
                                  d_inner + 2 * cfg.ssm_state),
                },
                "attn_k": zeros(groups, batch_size, w, cfg.n_kv_heads, hd),
                "attn_v": zeros(groups, batch_size, w, cfg.n_kv_heads, hd),
                "length": 0,
            }
        every = cfg.slstm_every
        groups = cfg.n_layers // every
        m0 = ssm.mlstm_init_state(cfg, batch_size, device=dev)
        s0 = ssm.slstm_init_state(cfg, batch_size, device=dev)
        return {
            "mlstm": {f: getattr(m0, f).expand(groups, every - 1, *getattr(m0, f).shape).clone()
                      for f in ssm.XLSTMState._fields},
            "slstm": {f: getattr(s0, f).expand(groups, *getattr(s0, f).shape).clone()
                      for f in ssm.XLSTMState._fields},
            "length": 0,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: nn.Module, batch: dict, cache: dict) -> tuple[torch.Tensor, dict]:
        """Run the prompt ``batch["tokens"]`` (B, S) through the model,
        filling the decode cache (in place).  The batch also carries the
        frontends' embeddings (``patch_embeds``, ``frame_embeds``) and, for
        M-RoPE, optional ``positions`` (B, S, 3).  Returns last-position
        logits (B, V) and the cache."""
        with trace.span("model.prefill"):
            cfg = self.cfg
            cache, back = _stacks_whole(cache)
            if cfg.family in ("dense", "moe", "vlm"):
                x = _embed_tokens(cfg, params, batch)
                b, s = batch["tokens"].shape
                pos = _default_positions(cfg, b, s, batch, device=x.device)
                x, cache, _ = _run_decoder_stack(cfg, params, x, positions=pos, cache=cache,
                                                 use_chunked=s > CHUNKED_ABOVE)
            elif cfg.family == "encdec":
                memory = _run_encoder(cfg, params, batch["frame_embeds"])
                # the cross-attention k/v are projected once; decoding reuses
                # them.  On a mesh they take the layout the cache's (.., 1, ..)
                # leaves had (``state_shardings``': the head width over "model")
                for key, proj in (("cross_k", "wk"), ("cross_v", "wv")):
                    cache[key] = common.layout_of(torch.stack([
                        common.split_heads(linear(getattr(p.cross_attn, proj), memory),
                                           cfg.n_kv_heads) for p in params.dec_blocks]), cache[key])
                tokens = batch["tokens"]
                with trace.span("model.embed"):
                    x = common.layout_of(common.embed_lookup(params.embed.embedding, tokens)
                                         .to(memory.dtype), tokens)
                x, cache = _run_decoder_encdec(cfg, params, x, None, cache)
            elif cfg.family == "hybrid":
                x = _embed_tokens(cfg, params, batch)
                x, cache = _run_zamba(cfg, params, x, cache, decode=False)
            else:
                x = _embed_tokens(cfg, params, batch)
                x, cache = _run_xlstm(cfg, params, x, cache, decode=False)
            return _serving_logits(cfg, params, x[:, -1:]), _stacks_written_back(cache, back)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params: nn.Module, tokens: torch.Tensor, cache: dict,
                    extras: dict | None = None) -> tuple[torch.Tensor, dict]:
        """One decode step.  tokens: (B, 1) integer; ``extras`` may carry
        M-RoPE ``positions`` (B, 1, 3).  Returns (logits, cache)."""
        with trace.span("model.decode_step"):
            cfg = self.cfg
            cache, back = _stacks_whole(cache)
            with trace.span("model.embed"):
                x = common.layout_of(common.embed_lookup(params.embed.embedding, tokens)
                                     .to(common.dtype_of(cfg.dtype)), tokens)
            b = tokens.shape[0]
            if cfg.family in ("dense", "moe", "vlm"):
                length = torch.full((b, 1), cache["length"], dtype=torch.long, device=x.device)
                if cfg.rope_variant == "mrope":
                    pos = (extras or {}).get("positions", length[..., None].expand(b, 1, 3))
                else:
                    pos = length
                x, cache, _ = _run_decoder_stack(cfg, params, x, positions=pos, cache=cache,
                                                 use_chunked=False)
            elif cfg.family == "encdec":
                x, cache = _run_decoder_encdec(cfg, params, x, None, cache)
            elif cfg.family == "hybrid":
                x, cache = _run_zamba(cfg, params, x, cache, decode=True)
            else:
                x, cache = _run_xlstm(cfg, params, x, cache, decode=True)
            return _serving_logits(cfg, params, x), _stacks_written_back(cache, back)


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda") -> Model:
    return Model(cfg, device=device)
