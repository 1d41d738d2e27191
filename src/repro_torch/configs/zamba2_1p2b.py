"""zamba2-1.2b: hybrid — Mamba2 backbone with a weight-shared attention
block invoked periodically.  [arXiv:2411.15242; hf]

Sub-quadratic backbone ⇒ runs the long_500k cell.  The shared attention
block is applied every ``shared_attn_every`` Mamba2 layers over a bounded
local window so the 500k cell stays sub-quadratic (see DESIGN.md
§Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    mamba_headdim=64,
    shared_attn_every=2,
    supports_long_context=True,
    rope_theta=1e4,
)
