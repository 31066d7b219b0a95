"""Coded-serving benchmark: tokens/s, TTFT, and simulated TTFT tails.

Port of ``benchmarks/serve_bench.py``, in process (no virtual-device
subprocess: the port has one device and no mesh). Two halves:

* **Engine runs** -- the same requests drained through the
  continuous-batching engine three ways on one parameter build: coded
  prefill (expander d=2) under Bernoulli p=0.2, coded at p=0, and
  uncoded d=1. Each reports tokens/s and its per-request synthetic
  TTFT p50/p99, after an untimed warm-up run (two short requests); the
  differential pins run inline: the coded p=0
  streams equal the uncoded streams and the sequential-batching
  reference loop's. On the card: granite-3-8b at its full config (40
  layers, d_model 4096, GQA 32/8; random weights from a seed, bf16
  activations), 8 slots, 16 requests of 96-128 prompt tokens, 32 new
  tokens, through K1 and K2. On the CPU (``--device cpu``): the
  reference's smoke sizes -- qwen1.5-4b's smoke variant, 12 requests,
  8 slots, ``max_len`` 48, 8 new tokens.
* **Latency quantiles** -- ``serve.latency.simulate_shard_ttft`` over
  ``CodingRuntime.weights_lookahead`` rounds at m = 32 replicas: paired
  coded/uncoded TTFT samples per straggler model, reduced to p50/p99
  rows. Host NumPy, bit-identical to the reference's at the same seed.

Inline acceptance, the reference's: bit-identical streams at p=0, and
coded p99 < uncoded p99 under the Bernoulli model at d=2.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import serve as S
from repro_torch.configs import CodingConfig, get_config
from repro_torch.dist import coded_train
from repro_torch.models import model as M

M_REPLICAS = 32
CARD = dict(arch="granite-3-8b", full=True, requests=16, slots=8,
            prompt_len=128, spread=32, new_tokens=32, max_len=1024)
CPU = dict(arch="qwen1.5-4b", full=False, requests=12, slots=8,
           prompt_len=12, spread=3, new_tokens=8, max_len=48)


def requests(cfg, n: int, prompt_len: int, spread: int, new_tokens: int,
             seed: int = 0) -> List[S.Request]:
    """Prompts of ``prompt_len - (i % (spread + 1))`` tokens, drawn from
    ``seed`` (the reference bench's 12 - i % 4 at its sizes)."""
    rng = np.random.default_rng(seed)
    return [S.Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, prompt_len - (i % (spread + 1))),
                max_new_tokens=new_tokens) for i in range(n)]


def _engine_run(cfg, params, reqs, *, scheme: str, p: float, slots: int,
                max_len: int) -> dict:
    coding = CodingConfig(scheme=scheme, replication=2,
                          straggler_model="bernoulli", straggler_p=p,
                          seed=0)
    eng = S.ServeEngine(cfg, params, n_slots=slots, max_len=max_len,
                        coding=coding, m_replicas=8, log_every=8)
    for r in reqs:
        eng.submit(r)
    summary = eng.run()
    summary.update(scheme=scheme, straggler_p=p)
    return {"summary": summary, "results": eng.results()}


def latency_rows(rounds: int, device) -> Dict:
    """The latency half: (rows, coded p99, uncoded p99 under
    Bernoulli)."""
    lat_model = S.ReplicaLatencyModel(m=M_REPLICAS)
    rows = []
    coded_p99 = uncoded_p99 = None
    for model, p in (("bernoulli", 0.2), ("markov", 0.2)):
        coding = CodingConfig(scheme="expander", replication=2,
                              straggler_model=model, straggler_p=p,
                              seed=1)
        rt = coded_train.CodingRuntime(coding, M_REPLICAS, debias=False,
                                       device=device)
        W, alive = rt.weights_lookahead(rounds)
        lat_rng = np.random.default_rng(2)
        lat = np.stack([lat_model.latencies(a, lat_rng) for a in alive])
        coded, uncoded = S.simulate_shard_ttft(
            rt.assignment, W, alive, lat,
            deadline_ms=lat_model.deadline_ms,
            straggle_ms=lat_model.straggle_ms)
        c_row = S.percentile_row("expander_d2", model, p, coded)
        u_row = S.percentile_row("uncoded", model, p, uncoded)
        rows += [c_row, u_row]
        if model == "bernoulli":
            coded_p99, uncoded_p99 = c_row["p99_ms"], u_row["p99_ms"]
    return {"rows": rows, "coded_p99_ms": coded_p99,
            "uncoded_p99_ms": uncoded_p99}


@torch.no_grad()
def main(dev: torch.device, fast: bool = True, seed: int = 0) -> dict:
    size = CARD if dev.type == "cuda" else CPU
    cfg = get_config(size["arch"])
    if not size["full"]:
        cfg = cfg.smoke_variant()
    n_req = size["requests"] * (1 if fast else 2)
    slots, max_len = size["slots"], size["max_len"]
    reqs = requests(cfg, n_req, size["prompt_len"], size["spread"],
                    size["new_tokens"], seed=seed)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    # untimed warm-up: the kernels' first loads and the allocator's
    # first blocks are not the engine's tokens/s
    _engine_run(cfg, params, requests(cfg, 2, 8, 0, 2, seed=seed + 1),
                scheme="expander", p=0.2, slots=slots, max_len=max_len)

    runs = {
        "coded": _engine_run(cfg, params, reqs, scheme="expander", p=0.2,
                             slots=slots, max_len=max_len),
        "coded_p0": _engine_run(cfg, params, reqs, scheme="expander",
                                p=0.0, slots=slots, max_len=max_len),
        "uncoded": _engine_run(cfg, params, reqs, scheme="uncoded", p=0.0,
                               slots=slots, max_len=max_len),
    }
    ref = S.sequential_serve(params, cfg, reqs, n_slots=slots,
                             max_len=max_len)
    stream_ok = all(
        np.array_equal(runs["coded_p0"]["results"][r.uid],
                       runs["uncoded"]["results"][r.uid])
        and np.array_equal(runs["coded_p0"]["results"][r.uid], ref[r.uid])
        for r in reqs)
    toks = np.concatenate(list(runs["coded"]["results"].values()))
    tokens_ok = bool(len(toks) == n_req * size["new_tokens"]
                     and toks.min() >= 0 and toks.max() < cfg.vocab_size)
    del params

    rounds = 6000 if fast else 20000
    lat = latency_rows(rounds, dev)
    report = {
        "arch": cfg.name, "full_config": size["full"],
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "slots": slots, "max_len": max_len,
        "requests": n_req, "new_tokens_per_request": size["new_tokens"],
        "build_s": build_s, "m_replicas_sim": M_REPLICAS,
        "rounds_sim": rounds,
        "engine": {k: v["summary"] for k, v in runs.items()},
        "latency_rows": lat["rows"],
        "acceptance": {
            "token_stream_bit_identical_at_p0": bool(stream_ok),
            "tokens_in_vocab": tokens_ok,
            "coded_p99_ms": lat["coded_p99_ms"],
            "uncoded_p99_ms": lat["uncoded_p99_ms"],
            "coded_p99_lt_uncoded": bool(lat["coded_p99_ms"]
                                         < lat["uncoded_p99_ms"]),
        },
    }
    for name, s in report["engine"].items():
        print(f"  engine[{name}]: {s['tokens_per_s']:.1f} tok/s over "
              f"{s['requests']} reqs, {s['retries']} retries, TTFT p50 "
              f"{s['ttft_p50_ms']:.1f} ms p99 {s['ttft_p99_ms']:.1f} ms")
    for row in report["latency_rows"]:
        print(f"  sim[{row['scheme']}/{row['straggler_model']} "
              f"p={row['p']}]: p50 {row['p50_ms']:.2f} ms, "
              f"p99 {row['p99_ms']:.2f} ms")
    acc = report["acceptance"]
    if not acc["token_stream_bit_identical_at_p0"]:
        raise AssertionError("coded p=0 streams diverged from the "
                             "single-replica oracle")
    if not acc["tokens_in_vocab"]:
        raise AssertionError("unexpected generated tokens")
    if not acc["coded_p99_lt_uncoded"]:
        raise AssertionError(
            f"coded p99 {acc['coded_p99_ms']} ms must beat uncoded "
            f"{acc['uncoded_p99_ms']} ms under bernoulli stragglers")
    print(f"  acceptance: bit-identical streams at p=0; coded p99 "
          f"{acc['coded_p99_ms']:.2f} ms < uncoded "
          f"{acc['uncoded_p99_ms']:.2f} ms")
    return report
