"""Where a serving pool step's time goes on the card.

    python -m repro_torch.launch.step_profile --arch granite-3-8b \
        --full-config --slots 8 --max-len 1024 --pos 144

Builds the model (random weights from ``--seed``), a full slot pool whose
rows all sit at cache position ``--pos`` (the KV caches'; a recurrent
state just runs on), and times the pool step three ways, printing one
JSON line. The families the engine serves (dense, moe, hybrid, ssm):

- ``host_ms_per_step``: wall time per step over ``--steps`` steps issued
  back to back from Python -- what the engine pays today;
- ``device_ms_per_step`` and ``device_busy_share``: the sum of kernel
  durations over a ``torch.profiler`` window, per step and as a share of
  that window's wall time, with the largest kernels by name ("not
  measured" when the profiler reports no device time);
- ``graph_ms_per_step``: the same step captured once in a CUDA graph and
  replayed, i.e. the step with the host's launch gaps removed.

Timing starts after warm-up steps. Cache contents are whatever the warm-up
steps wrote; the step's cost depends on positions, not values.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch import serve as S
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.launch import timing
from repro_torch.models import model as M


def main(argv=None, cfg: Optional[ModelConfig] = None) -> dict:
    """``cfg``, a ``ModelConfig`` from a caller, replaces ``--arch`` and
    ``--full-config``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--pos", type=int, default=144,
                    help="cache position of every row when timing")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = _device.resolve("cuda")
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full_config:
            cfg = cfg.smoke_variant()
    params = M.cast_block_weights(
        M.init_params(cfg, seed=args.seed, device=dev), cfg)
    B = args.slots
    cache = M.init_decode_cache(cfg, B, args.max_len, pos=args.pos,
                                device=dev)
    step = S.PoolStep(cfg, cfg.sliding_window)
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    forced = torch.arange(B, dtype=torch.int32, device=dev)
    use = torch.zeros(B, dtype=torch.bool, device=dev)
    alpha = torch.ones(B, dtype=torch.float32, device=dev)
    # every KV cache's position (none in an xLSTM's recurrent state)
    pos = [leaf for keys, leaf in S.cache_pool._leaves(cache)
           if keys[-1] == "pos"]

    def one():
        nonlocal tok
        tok, _ = step(params, cache, tok, forced, use, alpha)
        for p in pos:
            p.fill_(args.pos)        # every timed step at the same depth

    host_ms = timing.call_ms(one, iters=args.steps, warmup=3)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # kernel events only: an aten op's own device time repeats the
        # durations of the kernels it launched
        if getattr(ev, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    families = {}
    for name, ms in by_name.items():
        fam = ("rmsnorm" if "rmsnorm_kernel" in name else
               "decode_attention" if "decode_attention" in name else
               "gemm" if any(g in name for g in ("gemm", "nvjet", "splitK"))
               else "other")
        families[fam] = families.get(fam, 0.0) + ms / args.steps

    graph_ms = timing.graph_ms(one, reps=1, iters=args.steps)

    out = {
        "arch": cfg.name, "slots": B, "pos": args.pos,
        "device": torch.cuda.get_device_name(dev),
        "host_ms_per_step": host_ms,
        "graph_ms_per_step": graph_ms,
        "device_ms_per_step": (device_ms / args.steps if device_ms
                               else "not measured"),
        "device_busy_share": (device_ms / window_ms if device_ms
                              else "not measured"),
        "kernel_families_ms_per_step": families,
        "top_kernels_ms_per_step": {k: v / args.steps for k, v in top},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
