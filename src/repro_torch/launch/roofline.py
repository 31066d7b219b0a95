"""Roofline bookkeeping: model FLOPs (6*N*D), the card's constants, and
the three-term report assembled from ``step_analysis.analyze``.

Port of ``repro.launch.roofline`` with the hardware of this port: one
NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, NVIDIA's data
sheet, dense rates without sparsity. ``param_count`` counts over
``models.convert.param_shapes`` instead of an abstract initialisation.
"""

from __future__ import annotations

import math
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.convert import param_shapes

# NVIDIA H100 80GB HBM3, 700 W: tensor-core bf16 for bf16 steps; float32
# outside the tensor cores for float32 steps (TF32 is off, device.py).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth.
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W: fourth-generation NVLink, 900 GB/s in
# both directions together, so 450 GB/s each way.
NVLINK_BW = 450e9
# NVIDIA H100 80GB HBM3: device memory, in bytes.
HBM_BYTES = 80e9
CARD = "NVIDIA H100 80GB HBM3, 700 W"


def param_count(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in param_shapes(cfg).values()))


def _expert_param_count(cfg: ModelConfig) -> int:
    if not cfg.n_experts:
        return 0
    per_layer = 3 * cfg.n_experts * cfg.d_model * cfg.expert_d_ff
    return cfg.n_layers * per_layer


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: total minus the inactive routed-expert
    fraction (MoE)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert = _expert_param_count(cfg)
    active_frac = cfg.top_k / cfg.n_experts
    return int(total - expert * (1.0 - active_frac))


def model_flops(cfg: ModelConfig, shape: ShapeSpec, *,
                replication: float = 1.0) -> Dict[str, float]:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (fwd-only),
    where D counts the *unreplicated* dataset tokens of the step;
    ``replicated`` additionally reports the gradient-coding d-fold work
    (the useful-work ratio shows the coding overhead explicitly)."""
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_act * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n_act * tokens
    else:  # decode: one token per request
        tokens = shape.global_batch
        base = 2.0 * n_act * tokens
    return {
        "n_params": float(param_count(cfg)),
        "n_active_params": float(n_act),
        "tokens": float(tokens),
        "model_flops": base,
        "model_flops_replicated": base * (replication
                                          if shape.kind == "train"
                                          else 1.0),
    }


def roofline_report(stats: Dict, n_chips: int, model: Dict[str, float],
                    *, dtype: str = "bfloat16") -> Dict[str, float]:
    """Three roofline terms of one card's share of the step. ``stats``
    is ``step_analysis.analyze`` of the per-card step; ``dtype`` picks
    the peak rate (the config's compute dtype). The keys are the
    reference's: ``hlo_flops_*`` hold the matmul FLOPs counted in the
    eager step (there is no HLO here)."""
    flops = stats["flops"]
    dot_bytes = stats["dot_bytes"]
    cbytes = stats["collective_bytes"]
    t_compute = flops / PEAK_FLOPS[dtype]
    t_memory = dot_bytes / HBM_BW
    t_collective = cbytes / NVLINK_BW
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_collective)), key=lambda kv: kv[1])
    total_flops = flops * n_chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dom[0],
        "hlo_flops_per_chip": flops,
        "hlo_flops_total": total_flops,
        "dot_bytes_per_chip": dot_bytes,
        "collective_bytes_per_chip": cbytes,
        "useful_flops_ratio": (model["model_flops"] / total_flops
                               if total_flops else 0.0),
        "collectives": stats["collectives"],
        "peak_flops": PEAK_FLOPS[dtype],
        "card": CARD,
    }
