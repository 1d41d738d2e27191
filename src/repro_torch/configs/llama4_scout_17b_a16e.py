"""llama4-scout-17b-a16e: 48L MoE 16 experts top-1 + shared expert, early
fusion (text path here; fused modality enters as embeddings).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
    ),
    rope_theta=5e5,
)
