"""The dense decoder family's plain float32 forward (qwen2-7b): embedding;
``n_layers`` blocks of pre-normed GQA attention (biases on q, k and v where
the weights have them, rotary positions, causal) and pre-normed SwiGLU,
each added to the residual; the final norm and the LM head."""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from bench.reference.common import Weights, gqa_block, rmsnorm, swiglu


def hidden(w: Weights, tokens: torch.Tensor, m: dict, *, checkpoint: bool = False):
    """The final hidden states (B, S, d), before the final norm, of token
    rows from position 0."""
    eps = m["norm_eps"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = w.act(w["embed.embedding"][tokens])
    for i in range(m["n_layers"]):

        def block(x_, pre=f"blocks.{i}"):
            x_ = w.act(x_ + gqa_block(w, w.act(rmsnorm(x_, w[pre + ".ln1.scale"], eps)),
                                      pre + ".attn", m, positions, None))
            return w.act(x_ + swiglu(w, w.act(rmsnorm(x_, w[pre + ".ln2.scale"], eps)),
                                     pre + ".ffn"))

        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
        else:
            x = block(x)
    return x
