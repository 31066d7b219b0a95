"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend stubbed (patch embeddings), decoder
is mistral-nemo. [hf:mistralai/Pixtral-12B-2409]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    prefix_len=1024,  # stub patch-embedding prefix
    source="hf:mistralai/Pixtral-12B-2409",
)
