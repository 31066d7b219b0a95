"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400; 2 shared + 64 routed experts top-6, fine-grained.
[arXiv:2401.06066]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    source="arXiv:2401.06066",
)
