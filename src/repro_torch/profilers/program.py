"""Program profiler: architecture config + shape → stage-level WCG inputs.

The paper's program profiler walks a call graph measuring per-method time
and per-invocation transfer bytes (§6.1).  Here the "program" is a model
config and the "methods" are pipeline-able stages; costs are *analytic*
(FLOPs, HBM bytes, activation bytes) — exactly the quantities a dynamic
profiler would measure on hardware, derived instead from the architecture
algebra.  The output plugs into ``core.placement.build_stage_wcg``
unchanged, so swapping analytic → measured numbers on a real fleet does
not touch the partitioning stack.

Stage granularity: embed | one vertex per transformer layer (or layer
group) | head.  Embed is pinned to the local tier (the paper's
camera/GPS-style unoffloadable source); for decode shapes the head/sampler
is pinned local too (tokens must return to the serving front-end).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_models import AppProfile
from repro_torch.core.placement import StageSpec

__all__ = ["layer_flops", "layer_param_bytes", "stage_specs", "app_profile_from_config"]

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def _attn_kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes appended per token per layer."""
    b = _DTYPE_BYTES[cfg.dtype]
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return (m.kv_lora_rank + m.qk_rope_head_dim) * b
    return 2 * cfg.n_kv_heads * cfg.resolved_head_dim * b


def layer_param_count(cfg: ModelConfig) -> int:
    """Average parameters per layer (experts included once — they are
    weights that must live somewhere, which is what placement cares about)."""
    n_layers = max(cfg.n_layers, 1)
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return max((cfg.param_count() - embed) // n_layers, 1)


def active_layer_param_count(cfg: ModelConfig) -> int:
    """Average *active* parameters per layer (MoE: routed-to experts only)."""
    n_layers = max(cfg.n_layers, 1)
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return max((cfg.active_param_count() - embed) // n_layers, 1)


def layer_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """FLOPs per step for ONE layer under the given shape.

    matmul term: 2·P_active·tokens (×3 for train fwd+bwd).
    attention term: 4·B·S²·d_attn·causal_factor (quadratic mixers only);
    decode reads the cache instead: 4·B·S_cache·d_attn.
    """
    p_act = active_layer_param_count(cfg)
    tokens = shape.tokens
    mm = 2.0 * p_act * tokens
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    if cfg.attn_kind == "none" or cfg.family == "ssm":
        attn = 0.0
        # SSD/recurrent mixing: linear in S — fold into an effective matmul
        attn = 2.0 * tokens * cfg.d_model * max(cfg.ssm_state, 16)
    elif shape.kind == "decode":
        attn = 4.0 * shape.global_batch * shape.seq_len * d_attn
    else:
        attn = 2.0 * shape.global_batch * (shape.seq_len**2) * d_attn  # causal ½·4
    total = mm + attn
    if shape.kind == "train":
        total *= 3.0  # backward ≈ 2× forward
    return total


def layer_param_bytes(cfg: ModelConfig) -> float:
    return layer_param_count(cfg) * _DTYPE_BYTES[cfg.dtype]


def layer_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """HBM traffic per layer per step: weights + activations (+ KV reads)."""
    b = _DTYPE_BYTES[cfg.dtype]
    act = shape.tokens * cfg.d_model * b * 4  # read+write, residual+branch
    kv = 0.0
    if shape.kind == "decode" and cfg.attn_kind != "none" and cfg.family != "ssm":
        kv = shape.global_batch * shape.seq_len * _attn_kv_bytes_per_token(cfg)
    w = layer_param_bytes(cfg)
    if shape.kind == "train":
        act *= 3  # grads/recompute traffic
        w *= 3    # read weights fwd+bwd, write grads
    return w + act + kv


def boundary_act_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Bytes crossing a layer→layer cut per step (the WCG edge numerator)."""
    b = _DTYPE_BYTES[cfg.dtype]
    per = shape.tokens * cfg.d_model * b
    if shape.kind == "train":
        per *= 2  # activations forward + activation-grads backward
    return per


def stage_specs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    group: int = 1,
    pin_head_local: bool | None = None,
) -> list[StageSpec]:
    """One StageSpec per layer group, plus pinned embed/head stages."""
    if pin_head_local is None:
        pin_head_local = shape.kind == "decode"  # sampler feeds the front-end
    b = _DTYPE_BYTES[cfg.dtype]
    n_groups = max(cfg.n_layers // group, 1)
    lf = layer_flops(cfg, shape) * group
    lb = layer_hbm_bytes(cfg, shape) * group
    edge = boundary_act_bytes(cfg, shape)

    embed_flops = 2.0 * shape.tokens * cfg.d_model
    head_flops = 2.0 * shape.tokens * cfg.d_model * cfg.vocab_size
    if shape.kind == "decode":
        head_flops = 2.0 * shape.global_batch * cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        head_flops *= 3.0

    stages = [
        StageSpec(
            name="embed",
            flops=embed_flops,
            bytes_hbm=shape.tokens * cfg.d_model * b,
            act_bytes_out=edge,
            params_bytes=cfg.vocab_size * cfg.d_model * b,
            pinned_tier=0,
        )
    ]
    for g in range(n_groups):
        stages.append(
            StageSpec(
                name=f"layers[{g * group}:{(g + 1) * group}]",
                flops=lf,
                bytes_hbm=lb,
                act_bytes_out=edge,
                params_bytes=layer_param_bytes(cfg) * group,
            )
        )
    stages.append(
        StageSpec(
            name="head",
            flops=head_flops,
            bytes_hbm=cfg.vocab_size * cfg.d_model * b,
            act_bytes_out=shape.tokens * 4.0,  # token ids / logits summary back
            params_bytes=cfg.vocab_size * cfg.d_model * b,
            pinned_tier=0 if pin_head_local else None,
        )
    )
    return stages


def app_profile_from_config(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    group: int = 1,
    local_flops_per_s: float = 197e12 * 256,
) -> AppProfile:
    """Paper-style AppProfile (t_local per task, transfer bytes per edge).

    ``t_local`` is the stage time on the *local* tier; cost models scale
    the cloud side by F and the edges by the measured bandwidth — this is
    the object the adaptive controller re-prices as the environment drifts.
    """
    import numpy as np

    stages = stage_specs(cfg, shape, group=group)
    n = len(stages)
    t_local = np.array([s.flops / local_flops_per_s for s in stages])
    data_in = np.zeros((n, n))
    data_out = np.zeros((n, n))
    for i, st in enumerate(stages):
        succ = st.successors if st.successors else ((i + 1,) if i + 1 < n else ())
        for j in succ:
            data_in[i, j] = st.act_bytes_out
    offloadable = np.array([s.pinned_tier is None for s in stages])
    return AppProfile(
        t_local=t_local,
        data_in=data_in,
        data_out=data_out,
        offloadable=offloadable,
        names=[s.name for s in stages],
    )
