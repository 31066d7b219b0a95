"""Meta-tensor input specs for every (architecture x input shape), with
their placements -- the dry-run's contract.

Port of ``repro.launch.specs``. The reference's ``ShapeDtypeStruct``
stand-ins are ``device="meta"`` tensors here: shapes and dtypes with no
storage, so a full-size spec costs no memory. Parameters come from
``models.convert.param_shapes``, AdamW's state from the port's own
``init`` on those, the decode cache from ``init_decode_cache`` on the
meta device; placements (one tuple per leaf) from ``dist.sharding``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import CodingConfig, ModelConfig, ShapeSpec
from repro_torch.dist import sharding as rules
from repro_torch.models import model as M
from repro_torch.models.convert import param_shapes
from repro_torch.optim import optimizers as opt_mod
from .mesh import num_coded_workers

LONG_WINDOW = 8192  # sliding window used for long_500k serving
META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    return torch.empty(tuple(int(s) for s in shape), dtype=dt, device=META)


def meta_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors."""
    return T.unflatten({k: meta(s, cfg.param_dtype)
                        for k, s in param_shapes(cfg).items()})


def long_500k_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Which archs run the 500k decode, and why/why not."""
    if cfg.arch_type == "audio":
        return False, ("enc-dec with a bounded source window does not "
                       "define a 500k-token decoder cache; skipped")
    if cfg.arch_type in ("ssm", "hybrid"):
        return True, "O(1)-state recurrence"
    return True, f"sliding-window attention (window={LONG_WINDOW})"


def decode_supported(cfg: ModelConfig) -> bool:
    return True  # all assigned archs are decoders or enc-dec


@dataclasses.dataclass
class StepSpec:
    """Everything the dry-run needs for one (arch, shape, layout)."""

    kind: str                       # train | prefill | decode
    args: tuple                     # meta-tensor trees
    placements: tuple               # one placement tree per arg
    window: Optional[int] = None


def _coded_geometry(layout, coding: CodingConfig,
                    global_batch: int) -> Tuple[int, int, int]:
    m = num_coded_workers(layout)
    d = coding.replication
    n_blocks = 2 * m // d
    if global_batch % n_blocks:
        raise ValueError(f"global batch {global_batch} % n_blocks "
                         f"{n_blocks} != 0")
    return m, n_blocks, global_batch // n_blocks


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - cfg.prefix_len if cfg.arch_type in ("vlm", "audio") else S


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, layout,
                      coding: CodingConfig):
    """(batch meta dict, batch placement dict) for the coded train step:
    the replicated machine batch (m, load, bs, ...)."""
    m, _n_blocks, bs = _coded_geometry(layout, coding, shape.global_batch)
    load = 2  # graph schemes: two blocks per machine
    S_text = _text_len(cfg, shape.seq_len)
    batch = {"tokens": meta((m, load, bs, S_text), torch.int32),
             "labels": meta((m, load, bs, S_text), torch.int32),
             "block_weight": meta((m, load), torch.float32)}
    if cfg.arch_type == "vlm":
        batch["prefix"] = meta((m, load, bs, cfg.prefix_len, cfg.d_model),
                               cfg.dtype)
    if cfg.arch_type == "audio":
        batch["src"] = meta((m, load, bs, cfg.prefix_len, cfg.d_model),
                            cfg.dtype)
    return batch, rules.leading_axis_specs(batch, layout)


def make_step_spec(cfg: ModelConfig, shape: ShapeSpec, layout,
                   coding: Optional[CodingConfig] = None,
                   optimizer_name: str = "adamw",
                   fsdp: bool = False) -> StepSpec:
    """The StepSpec for one (arch, shape) on a layout. ``fsdp=True``
    places parameters and AdamW's moments by ``rules.fsdp_specs``
    instead of ``rules.safe_param_specs``."""
    coding = coding or CodingConfig()
    params = meta_params(cfg)
    param_spec = (rules.fsdp_specs if fsdp
                  else rules.safe_param_specs)(params, layout)
    da = rules.data_axes(layout)
    da1 = da if len(da) > 1 else da[0]

    if shape.kind == "train":
        optimizer = opt_mod.get_optimizer(optimizer_name, 1e-4)
        opt_state = optimizer.init(params)
        if optimizer_name == "adamw":
            opt_spec = {"step": (), "m": param_spec, "v": param_spec}
        else:
            opt_spec = T.map(lambda _: (), opt_state)
        batch, batch_spec = train_batch_specs(cfg, shape, layout, coding)
        wstar = meta((num_coded_workers(layout),), torch.float32)
        return StepSpec(kind="train",
                        args=(params, opt_state, batch, wstar),
                        placements=(param_spec, opt_spec, batch_spec, ()))

    if shape.kind == "prefill":
        B = shape.global_batch
        batch = {"tokens": meta((B, _text_len(cfg, shape.seq_len)),
                                torch.int32)}
        if cfg.arch_type == "vlm":
            batch["prefix"] = meta((B, cfg.prefix_len, cfg.d_model),
                                   cfg.dtype)
        if cfg.arch_type == "audio":
            batch["src"] = meta((B, cfg.prefix_len, cfg.d_model),
                                cfg.dtype)
        return StepSpec(kind="prefill", args=(params, batch),
                        placements=(param_spec,
                                    rules.leading_axis_specs(batch,
                                                             layout)))

    # decode
    B, S = shape.global_batch, shape.seq_len
    window = None
    if shape.name == "long_500k":
        ok, _why = long_500k_supported(cfg)
        if not ok:
            raise ValueError(f"{cfg.name} does not support long_500k")
        window = LONG_WINDOW
    kv_len = min(S, window or cfg.sliding_window or S)
    src_len = cfg.prefix_len if cfg.arch_type == "audio" else 0
    cache = M.init_decode_cache(
        cfg.with_overrides(sliding_window=window) if window else cfg, B,
        kv_len, pos=S - 1, src_len=src_len, device=META)
    batch_repl = B < math.prod(layout.shape[a] for a in da)
    cache_spec = rules.cache_specs(cache, layout,
                                   batch_replicated=batch_repl)
    tok = meta((B,), torch.int32)
    return StepSpec(kind="decode", args=(params, tok, cache),
                    placements=(param_spec, () if batch_repl else (da1,),
                                cache_spec),
                    window=window)
