"""Architecture & shape configuration system.

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro/configs/<id>.py``) exposing ``CONFIG`` with the exact published
hyper-parameters, plus a ``reduced()`` smoke-test variant of the same
family (tiny widths/depths, same code paths).

Shapes are global: each architecture is exercised on the four assigned
(seq_len × global_batch) cells; ``decode_*``/``long_*`` lower the serving
step (one new token against a KV cache of seq_len), not the train step.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "reduce_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    # layers that use a dense FFN instead of MoE (e.g. deepseek first layer)
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    router_noise: float = 0.0
    aux_loss_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 → d_model // n_heads
    # attention flavour
    attn_kind: Literal["full", "mla", "none"] = "full"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_variant: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 1e6
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # hybrid / ssm
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    mamba_headdim: int = 64
    shared_attn_every: int = 0              # zamba2: shared block cadence
    slstm_every: int = 0                    # xlstm: sLSTM cadence (else mLSTM)
    xlstm_proj_factor: float = 2.0
    # enc-dec
    encoder_layers: int = 0
    # frontends (stubs — assignment: modality frontends provide embeddings)
    frontend: Literal["none", "vision_patches", "audio_frames"] = "none"
    frontend_seq: int = 0                   # tokens contributed by the stub
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # which shapes are valid ("long_500k" only for sub-quadratic mixers)
    supports_long_context: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        return self.supports_long_context

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D MODEL_FLOPS and docs)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla or MLAConfig()
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * nq * qk_head      # W_DQ, W_UQ
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)            # W_DKV + k_rope
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d                                # W_O
                return p
            if self.attn_kind == "none":
                return 0
            p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * hd
            return p

        def ffn_params(layer: int) -> int:
            if self.moe is not None and layer >= self.moe.first_dense_layers:
                m = self.moe
                expert = 3 * d * m.d_ff_expert
                shared = m.num_shared_experts * 3 * d * m.d_ff_shared
                router = d * m.num_experts
                return m.num_experts * expert + shared + router
            if self.moe is not None and self.moe.d_ff_dense:
                return 3 * d * self.moe.d_ff_dense
            return 3 * d * dff if dff else 0

        def mamba_params() -> int:
            d_inner = self.ssm_expand * d
            n_heads_m = d_inner // self.mamba_headdim
            p = d * (2 * d_inner + 2 * self.ssm_state + n_heads_m)  # in_proj(x,z,B,C,dt)
            p += d_inner * self.ssm_conv                             # conv
            p += n_heads_m * 2                                       # A, D
            p += d_inner * d                                         # out_proj
            return p

        def xlstm_params(slstm: bool) -> int:
            # mirrors ssm.init_mlstm / init_slstm exactly
            dh = d // self.n_heads
            up = int(self.xlstm_proj_factor * d)
            if slstm:
                # w_in (d,4d) + r (4,H,dh,dh) + b (4,H,dh) + w_up + w_down
                return d * 4 * d + 4 * self.n_heads * dh * dh + 4 * d + 2 * d * up
            # w_up + w_gatez (d,up each) + wq/wk/wv (up,up) + w_if (up,2H) + w_down
            return 2 * d * up + 3 * up * up + up * 2 * self.n_heads + up * d

        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d

        if self.family in ("dense", "moe", "vlm"):
            for layer in range(self.n_layers):
                total += attn_params() + ffn_params(layer) + 2 * d
        elif self.family == "encdec":
            enc = self.encoder_layers or self.n_layers
            total += enc * (attn_params() + 3 * d * dff + 2 * d)
            # decoder: self-attn + cross-attn + ffn
            total += self.n_layers * (2 * attn_params() + 3 * d * dff + 3 * d)
        elif self.family == "hybrid":
            total += self.n_layers * (mamba_params() + 2 * d)
            total += attn_params() + 3 * d * dff + 2 * d  # one shared block
        elif self.family == "ssm":
            n_s = self.n_layers // max(self.slstm_every, 1) if self.slstm_every else 0
            n_m = self.n_layers - n_s
            total += n_m * xlstm_params(False) + n_s * xlstm_params(True)
            total += self.n_layers * 2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed-to experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        per_expert = 3 * d * m.d_ff_expert
        inactive = (m.num_experts - m.top_k) * per_expert
        n_moe_layers = self.n_layers - m.first_dense_layers
        return int(self.param_count() - n_moe_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/code paths, tiny sizes."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family != "ssm" else 8),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_chunk=16,
        mamba_headdim=16,
        frontend_seq=8 if cfg.frontend != "none" else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
    )
    if cfg.rope_variant == "mrope":
        # rescale the three M-RoPE sections to the reduced head_dim (hd/2 freqs)
        half = small["head_dim"] // 2
        s0 = half // 4
        s1 = (half - s0) // 2
        small["mrope_sections"] = (s0, s1, half - s0 - s1)
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.num_shared_experts else 0,
            d_ff_dense=128 if cfg.moe.first_dense_layers else 0,
        )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=48,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.slstm_every:
        small["slstm_every"] = 4
    if cfg.shared_attn_every:
        small["shared_attn_every"] = 2
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
