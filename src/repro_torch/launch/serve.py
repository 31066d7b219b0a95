"""Serving driver: the CLI over the continuous-batching coded engine.

Builds a ``repro_torch.serve.ServeEngine`` -- admission queue,
fixed-slot cache pool, iteration-level prefill/decode interleave, and
(with ``--scheme expander``) d-replicated coded prefill with
optimal-decode combine weights and a synthetic per-replica latency
model -- then drains ``--requests`` synthetic prompts through it and
prints a JSON summary line (tokens/s, synthetic TTFT p50/p99, retries).

  python -m repro_torch.launch.serve --arch granite-3-8b --full-config \
      --scheme expander --check

Runs on the GPU unless ``--device cpu`` is given; weights are random,
made on the device from ``--seed``. ``--check`` re-serves the same
requests through the sequential-batching reference loop and asserts
bit-identical token streams. The summary's ``pool_steps`` counts every
pool step this run took (engine and reference loop).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import serve as S
from repro_torch.configs import ARCH_IDS, CodingConfig, get_config
from repro_torch.models import model as M


def _build_requests(args, cfg):
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        # vary lengths (bounded by --prompt-spread) so the interleave
        # actually schedules prefill against decode
        plen = args.prompt_len - (i % (args.prompt_spread + 1))
        plen = max(1, plen)
        reqs.append(S.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=args.max_new_tokens))
    return reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4,
                    help="pool width: requests decoded concurrently")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-spread", type=int, default=3,
                    help="prompt lengths vary in [len-spread, len]")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64,
                    help="decode-cache capacity per slot")
    ap.add_argument("--scheme", default="expander",
                    choices=("expander", "uncoded"),
                    help="expander: d-replicated coded prefill; "
                         "uncoded: single replica per shard")
    ap.add_argument("--replicas", type=int, default=8,
                    help="replica slices m for the latency model")
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--decoding", default="optimal",
                    choices=("optimal", "fixed"))
    ap.add_argument("--straggler-model", default="bernoulli",
                    choices=("bernoulli", "markov", "adversarial"))
    ap.add_argument("--straggler-p", type=float, default=0.1)
    ap.add_argument("--base-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=6.0)
    ap.add_argument("--straggle-ms", type=float, default=60.0)
    ap.add_argument("--log-every", type=int, default=16,
                    help="iterations between host token fetches")
    ap.add_argument("--check", action="store_true",
                    help="pin the engine streams against the "
                         "sequential-batching reference loop")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke_variant()
    if cfg.arch_type not in M.SUPPORTED_ARCH_TYPES:
        ap.error(f"arch_type {cfg.arch_type!r} is not ported yet; "
                 f"the port serves {M.SUPPORTED_ARCH_TYPES}")

    # Validate the generation budget against the cache capacity before
    # touching the device.
    try:
        S.validate_budget(cfg, args.prompt_len, args.max_new_tokens,
                          args.max_len)
    except ValueError as e:
        ap.error(str(e))

    dev = _device.resolve(args.device)
    params = M.cast_block_weights(
        M.init_params(cfg, seed=args.seed, device=dev), cfg)
    reqs = _build_requests(args, cfg)
    coding = CodingConfig(
        scheme=args.scheme, replication=args.replication,
        decoding=args.decoding, straggler_model=args.straggler_model,
        straggler_p=args.straggler_p, seed=args.seed)
    latency = S.ReplicaLatencyModel(
        m=args.replicas, base_ms=args.base_ms,
        deadline_ms=args.deadline_ms, straggle_ms=args.straggle_ms)

    step = S.pool_step(cfg, cfg.sliding_window)
    steps0 = step.calls
    engine = S.ServeEngine(
        cfg, params, n_slots=args.slots, max_len=args.max_len,
        coding=coding, m_replicas=args.replicas, latency=latency,
        log_every=args.log_every)
    for r in reqs:
        engine.submit(r)
    summary = engine.run()
    results = engine.results()

    check_passed = None
    if args.check:
        ref = S.sequential_serve(params, cfg, reqs, n_slots=args.slots,
                                 max_len=args.max_len)
        check_passed = all(np.array_equal(results[r.uid], ref[r.uid])
                           for r in reqs)
        if not check_passed:
            raise AssertionError(
                "engine streams diverged from the sequential reference")

    summary.update(path="engine", arch=args.arch, scheme=args.scheme,
                   m_replicas=args.replicas,
                   replication=args.replication,
                   straggler_model=args.straggler_model,
                   straggler_p=args.straggler_p,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                   pool_steps=step.calls - steps0,
                   check_passed=check_passed,
                   sample=results[0][:12].tolist())
    print(json.dumps(summary))
    return {"results": results, "summary": summary}


if __name__ == "__main__":
    main()
