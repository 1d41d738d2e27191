"""deepseek-v2-236b: 60L MoE, MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

d_ff=1536 is the per-expert intermediate; the first layer uses a dense FFN
(d_ff_dense=12288) per the published architecture.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102_400,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
        first_dense_layers=1,
        d_ff_dense=12288,
    ),
    rope_theta=1e4,
)
