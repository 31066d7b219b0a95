"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base family]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
