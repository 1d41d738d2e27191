"""granite-34b: dense 88L code model, llama arch, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=1e5,
)
