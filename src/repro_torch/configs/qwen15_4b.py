"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
