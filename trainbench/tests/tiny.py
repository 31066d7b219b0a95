"""Cells at a size the CPU holds: the configurations' families at small
widths in float32, so that the program and the float32 reference agree
to rounding, with limits far below what any planted fault reads."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
          "alpha_gap": 1e-5}
SMALL = {
    "granite-3-8b-8L": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=128, vocab_size=300),
    "hybrid": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab_size=300, ssm_state=16,
                   attn_positions=[1]),
}
# The reference's hybrid family (Zamba2) has no cell; its model at the
# widths above.
HYBRID = {"name": "hybrid", "reference": "hybrid",
          "model": {"name": "hybrid", "arch_type": "hybrid", "ssm_expand": 2,
                    "ssm_conv": 4, "rope_theta": 10000.0,
                    "param_dtype": "float32", "norm_eps": 1e-5,
                    "tie_embeddings": True}}


def cell(config: str, traffic: str = "dedup-seq4k", *, seq_len: int = 40,
         dtype: str = "float32", chips: int = 1) -> dict:
    cfg = (json.loads(json.dumps(HYBRID)) if config == "hybrid" else
           json.loads((HERE / "configs" / f"{config}.json").read_text()))
    cfg["model"].update(SMALL[config], dtype=dtype)
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr["seq_len"] = seq_len
    return {"workload": {"name": f"{config}.{traffic}.small",
                         "chips": chips},
            "config": cfg, "traffic": tr, "limits": dict(LIMITS),
            "per_layer": []}
