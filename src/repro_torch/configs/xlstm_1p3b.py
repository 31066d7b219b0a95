"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM +
mLSTM blocks at 7:1 ratio. [arXiv:2405.04517]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_ratio=7,  # 7 mLSTM : 1 sLSTM per super-block (48 = 6 x 8)
    source="arXiv:2405.04517",
)
