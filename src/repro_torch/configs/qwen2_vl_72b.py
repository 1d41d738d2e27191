"""qwen2-vl-72b: VLM backbone 80L, M-RoPE, dynamic resolution (frontend is a
stub per the assignment — ``input_specs()`` provides precomputed patch
embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision_patches",
    frontend_seq=1024,
)
