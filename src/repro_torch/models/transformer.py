"""Model assembly: the hybrid (zamba2) family.

:class:`Model` is the facade the serving engine drives:

* ``init(seed)``                    — the parameters, an ``nn.Module``
* ``init_cache(batch, max_len)``    — the decode cache, a dict of tensors
* ``prefill(params, batch, cache)`` — run the prompt, fill the cache
* ``decode_step(params, tokens, cache)`` — one token with the cache

Zamba2 is a Mamba2 backbone with ONE set of attention + SwiGLU weights
invoked after every ``shared_attn_every`` Mamba2 layers, each invocation
with its own pre-norm scales.  The JAX package scans over stacked layer
parameters; here the layers are a Python loop over ``nn.Module``\\ s.
Every prefill runs the Mamba2 scan kernel once per Mamba2 layer, and a
prefill longer than 4096 tokens runs the flash-attention kernel once per
shared-block invocation.

Only ``family == "hybrid"`` is ported; the others raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mcop_phase import require_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common, ffn, ssm
from repro_torch.models.common import linear, rmsnorm

__all__ = ["Model", "ZambaLM", "build_model", "ZAMBA_WINDOW"]

ZAMBA_WINDOW = 4096  # shared-attn sliding window: keeps long contexts sub-quadratic


def _embed_tokens(cfg: ModelConfig, params: "ZambaLM", batch: dict) -> torch.Tensor:
    return params.embed.embedding[batch["tokens"]].to(common.dtype_of(cfg.dtype))


def _lm_logits(cfg: ModelConfig, params: "ZambaLM", x: torch.Tensor) -> torch.Tensor:
    return linear(params.lm_head, rmsnorm(params.final_norm, x, eps=cfg.norm_eps))


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
):
    """The layer stack.  With a cache, its tensors are updated in place and
    the returned dict holds them with the new length."""
    b, s, _ = x.shape
    dev = x.device
    length = cache["length"] if cache is not None else 0
    positions = (length + torch.arange(s, device=dev))[None, :].expand(b, s)
    for g, group in enumerate(params.mamba):
        # --- `every` mamba layers -----------------------------------------
        for i, p_m in enumerate(group):
            st = None
            if cache is not None:
                st = ssm.MambaState(cache["mamba"]["h"][g, i], cache["mamba"]["conv"][g, i])
            if decode:
                y, new_st = ssm.mamba2_step(cfg, p_m, x, st)
            else:
                y, new_st = ssm.mamba2_forward(cfg, p_m, x, st)
            x = x + y
            if cache is not None:
                cache["mamba"]["h"][g, i] = new_st.h
                cache["mamba"]["conv"][g, i] = new_st.conv

        # --- shared attention + FFN block ---------------------------------
        h = rmsnorm(params.shared_ln[g], x, eps=cfg.norm_eps)
        if cache is not None:
            kv = attn_lib.KVCache(cache["attn_k"][g], cache["attn_v"][g], length)
            a, _ = attn_lib.attention_forward(
                cfg, params.shared_attn, h, positions=positions, cache=kv,
                window=ZAMBA_WINDOW, ring=True, use_chunked=s > 4096,
            )
        else:
            a, _ = attn_lib.attention_forward(
                cfg, params.shared_attn, h, positions=positions,
                window=ZAMBA_WINDOW, use_chunked=s > 4096,
            )
        x = x + a
        h = rmsnorm(params.shared_ln2[g], x, eps=cfg.norm_eps)
        x = x + ffn.swiglu_forward(params.shared_ffn, h)
    if cache is None:
        return x, None
    return x, {"mamba": cache["mamba"], "attn_k": cache["attn_k"],
               "attn_v": cache["attn_v"], "length": length + s}


# ======================================================================
# Model facade
# ======================================================================

@dataclasses.dataclass
class Model:
    """``device`` is where parameters, caches and compute live (default the
    GPU; without one every method raises ``KernelError``)."""

    cfg: ModelConfig
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.cfg.family != "hybrid":
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet "
                "(ROADMAP Queue A, item 13)"
            )

    def _device(self) -> torch.device:
        return require_device(self.device)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> ZambaLM:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
        the model's device (on ``meta``: shapes only, nothing drawn)."""
        dev = self._device()
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        return _init_zamba(gen, self.cfg, device=dev)

    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dev = self._device()
        dt = common.dtype_of(cfg.dtype)
        hd = cfg.resolved_head_dim
        every = cfg.shared_attn_every
        groups = cfg.n_layers // every
        d_inner = cfg.ssm_expand * cfg.d_model
        n_heads_m = d_inner // cfg.mamba_headdim
        w = min(ZAMBA_WINDOW, max_len)
        return {
            "mamba": {
                "h": torch.zeros((groups, every, batch_size, n_heads_m,
                                  cfg.mamba_headdim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((groups, every, batch_size, cfg.ssm_conv - 1,
                                     d_inner + 2 * cfg.ssm_state), dtype=dt, device=dev),
            },
            "attn_k": torch.zeros((groups, batch_size, w, cfg.n_kv_heads, hd),
                                  dtype=dt, device=dev),
            "attn_v": torch.zeros((groups, batch_size, w, cfg.n_kv_heads, hd),
                                  dtype=dt, device=dev),
            "length": 0,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: ZambaLM, batch: dict, cache: dict) -> tuple[torch.Tensor, dict]:
        """Run the prompt ``batch["tokens"]`` (B, S) through the model,
        filling the decode cache (in place).  Returns last-position logits
        (B, V) and the cache."""
        x = _embed_tokens(self.cfg, params, batch)
        x, cache = _run_zamba(self.cfg, params, x, cache, decode=False)
        return _lm_logits(self.cfg, params, x[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params: ZambaLM, tokens: torch.Tensor,
                    cache: dict) -> tuple[torch.Tensor, dict]:
        """One decode step.  tokens: (B, 1) integer.  Returns (logits, cache)."""
        x = _embed_tokens(self.cfg, params, {"tokens": tokens})
        x, cache = _run_zamba(self.cfg, params, x, cache, decode=True)
        return _lm_logits(self.cfg, params, x)[:, 0], cache


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda") -> Model:
    return Model(cfg, device=device)
