"""xlstm-1.3b: 48 blocks of sLSTM + mLSTM (d_ff=0: the up/down projection
lives inside the xLSTM blocks).  [arXiv:2405.04517; unverified]

Recurrent (linear) sequence mixing ⇒ runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    attn_kind="none",
    rope_variant="none",
    slstm_every=8,
    xlstm_proj_factor=2.0,
    supports_long_context=True,
)
