"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192; MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    expert_d_ff=8192,
    sliding_window=8192,  # llama4 interleaves local attention natively
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
