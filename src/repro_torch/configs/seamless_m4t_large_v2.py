"""seamless-m4t-large-v2 [audio]: 24L decoder d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206; encoder-decoder, multimodal frontend stubbed
(precomputed frame embeddings). [arXiv:2308.11596]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    n_encoder_layers=24,
    prefix_len=1024,  # stub frame-embedding length (source sequence)
    source="arXiv:2308.11596",
)
