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

The vlm and audio families need a per-request prefix / source side
channel the pool does not carry; they take the reference's static-batch
path (``static_generate``): ``--slots`` prompts with their stub patch
embeddings (vlm) or frame embeddings (audio), a prefill, the encoder
output into ``cache["enc"]`` (audio), the prompts replayed through the
decode step and ``--max-new-tokens`` greedy tokens. As in the
reference, the prefill's logits are not carried into decoding.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import serve as S
from repro_torch.configs import (ARCH_IDS, CodingConfig, ModelConfig,
                                 get_config)
from repro_torch.dist import coded_train
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


@torch.no_grad()
def static_generate(params, cfg, prompts, *, max_len: int,
                    max_new_tokens: int, prefix=None, src=None) -> dict:
    """The static-batch path on the device of ``params``: prompts (B, P)
    int, prefix (B, Pv, D) for vlm, src (B, Ssrc, D) for audio. Returns
    the prefill's last-position logits, the last decode logits, the
    generated tokens (B, max_new_tokens) and the generation seconds."""
    dev = params["embed"]["table"].device
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    batch = {"tokens": prompts, "prefix": prefix, "src": src}
    prefill = coded_train.make_prefill_step(cfg)(params, batch)
    cache = M.init_decode_cache(
        cfg, B, max_len, src_len=src.shape[1] if src is not None else 0,
        device=dev)
    if src is not None:
        cache["enc"] = M.encode(params, src, cfg)
    step = coded_train.make_serve_step(cfg)
    logits = None
    for i in range(P):
        logits, cache = step(params, prompts[:, i], cache)
    out = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    for _ in range(max_new_tokens):
        out.append(tok)
        logits, cache = step(params, tok, cache)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    gen = torch.stack(out, dim=1).cpu().numpy()
    return {"prefill_logits": prefill, "logits": logits, "tokens": gen,
            "seconds": time.perf_counter() - t0}


def _static_main(args, cfg, dev) -> dict:
    """The reference's static-batch path (vlm, audio), with its inputs
    drawn from ``--seed`` in the reference's order."""
    params = M.cast_block_weights(
        M.init_params(cfg, seed=args.seed, device=dev), cfg)
    B = args.slots
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, args.prompt_len))
    stub = rng.normal(size=(B, cfg.prefix_len, cfg.d_model)) * 0.02
    stub = torch.from_numpy(stub).to(dev, getattr(torch, cfg.dtype))
    side = {"prefix": stub} if cfg.arch_type == "vlm" else {"src": stub}
    out = static_generate(params, cfg, prompts, max_len=args.max_len,
                          max_new_tokens=args.max_new_tokens, **side)
    if not torch.isfinite(out["logits"]).all():
        raise AssertionError("non-finite decode logits")
    gen = out["tokens"]
    summary = {"path": "static", "arch": args.arch, "requests": B,
               "new_tokens": int(gen.size),
               "tokens_per_s": gen.size / max(out["seconds"], 1e-9),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "sample": gen[0][:12].tolist()}
    print(json.dumps(summary))
    return {"tokens": gen, "summary": summary}


def main(argv=None, cfg: Optional[ModelConfig] = None) -> dict:
    """``cfg``, a ``ModelConfig`` from a caller, replaces ``--arch`` and
    ``--full-config`` (``--arch`` then only names the run)."""
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

    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full_config:
            cfg = cfg.smoke_variant()
    # Validate the generation budget against the cache capacity before
    # touching the device.
    try:
        S.validate_budget(cfg, args.prompt_len, args.max_new_tokens,
                          args.max_len)
    except ValueError as e:
        ap.error(str(e))

    dev = _device.resolve(args.device)
    if cfg.arch_type in ("vlm", "audio"):
        return _static_main(args, cfg, dev)
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
