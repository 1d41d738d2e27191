"""seamless-m4t-large-v2: encoder-decoder multimodal backbone (24L enc +
24L dec).  The speech frontend is a stub per the assignment —
``input_specs()`` provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    rope_variant="none",
    frontend="audio_frames",
    frontend_seq=1024,
)
