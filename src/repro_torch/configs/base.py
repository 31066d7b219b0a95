"""Model / run configuration dataclasses shared by the whole framework."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture configuration.

    ``arch_type`` in {dense, moe, hybrid, ssm, vlm, audio}. Hybrid =
    Mamba2 backbone with shared attention blocks (Zamba2); ssm = xLSTM;
    audio = encoder-decoder with a stubbed modality frontend; vlm =
    decoder with stubbed patch-embedding prefix.
    """

    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert hidden dim (fine-grained MoE)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_positions: Tuple[int, ...] = ()   # hybrid: shared-attn insertions
    # xLSTM
    slstm_ratio: int = 0          # mLSTM blocks per sLSTM block (0 = n/a)
    # enc-dec / multimodal
    n_encoder_layers: int = 0
    prefix_len: int = 0           # vlm patch / audio frame positions
    # numerics
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # citation
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded for clean sharding (standard practice; loss
        masks the padding ids)."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests:
        2 layers, d_model <= 512, <= 4 experts."""
        kw = dict(
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4,
            d_ff=512,
            vocab_size=512,
            dtype="float32",
            sliding_window=(64 if self.sliding_window else None),
        )
        if self.n_experts:
            kw.update(n_experts=4, n_shared_experts=min(self.n_shared_experts, 1),
                      top_k=min(self.top_k, 2), expert_d_ff=128)
        if self.ssm_state:
            kw.update(ssm_state=16)
        if self.attn_positions:
            kw.update(attn_positions=(1,))
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        if self.prefix_len:
            kw.update(prefix_len=8)
        return self.with_overrides(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class CodingConfig:
    """Gradient-coding runtime configuration (the paper's technique)."""

    # expander | frc | uncoded | cyclic_mds | bibd | random_regular
    scheme: str = "expander"
    replication: int = 4          # d
    decoding: str = "optimal"     # optimal | fixed
    straggler_model: str = "bernoulli"  # bernoulli | markov | adversarial
    straggler_p: float = 0.1
    shuffle_blocks: bool = True
    seed: int = 0
