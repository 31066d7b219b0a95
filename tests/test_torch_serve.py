"""The port's serving engine: its own differential pins, and its streams
against the JAX package's engine.

Within the port (CPU, bit-for-bit): the engine's per-request streams
equal ``sequential_serve``'s under continuous admission, and the coded
stream at p=0 equals the uncoded one.

Port against JAX: the same requests through both engines over the same
parameters (crossed through NumPy). Shard services (alpha, TTFT,
retries) are host NumPy in both and must be equal. Greedy tokens come
from float32 logits that agree to ``LOGIT_TOL`` (tests/test_torch_model
measures ~5e-6 at these sizes), so the streams must be equal unless
the reference's top-2 logit gap at the first differing step is itself
below that tolerance -- a near-tie, which then has to be shown.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as RS
from repro.configs import CodingConfig as RCoding, get_config as rget
from repro.models import model as RM
from repro_torch import serve as TS
from repro_torch.configs import CodingConfig as TCoding, get_config as tget
from repro_torch.models.convert import params_from_numpy

LOGIT_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dense():
    """granite-3-8b smoke with GQA (G = 2), float32, params from JAX."""
    rcfg = rget("granite-3-8b").smoke_variant().with_overrides(n_kv_heads=2)
    tcfg = tget("granite-3-8b").smoke_variant().with_overrides(n_kv_heads=2)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tcfg, tree, params_from_numpy(tree, tcfg, device="cpu")


def _requests(mod, cfg, n, seed, base_len=6, spread=3, new_tokens=4):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            base_len - (i % (spread + 1))),
                        max_new_tokens=new_tokens + (i % 2))
            for i in range(n)]


def _serve(mod, cfg, params, reqs, coding=None, **kw):
    eng = mod.ServeEngine(cfg, params, n_slots=4, max_len=32,
                          coding=coding, m_replicas=8, **kw)
    for r in reqs:
        eng.submit(r)
    summary = eng.run()
    return eng, summary


def test_engine_matches_sequential_reference(dense):
    _, cfg, _, params = dense
    reqs = _requests(TS, cfg, 7, 1)
    eng, summary = _serve(TS, cfg, params, reqs, log_every=3)
    assert summary["requests"] == 7 and summary["admissions"] == 7
    res = eng.results()
    ref = TS.sequential_serve(params, cfg, reqs, n_slots=4, max_len=32)
    for r in reqs:
        assert len(res[r.uid]) == r.max_new_tokens
        np.testing.assert_array_equal(res[r.uid], ref[r.uid])


def test_coded_stream_equals_uncoded_at_p0(dense):
    _, cfg, _, params = dense
    reqs = _requests(TS, cfg, 6, 2)

    def run(scheme):
        coding = TCoding(scheme=scheme, replication=2, straggler_p=0.0)
        return _serve(TS, cfg, params, reqs, coding, log_every=4)[0]

    coded, uncoded = run("expander"), run("uncoded")
    for r in reqs:
        assert coded.records[r.uid]["alpha"] == 1.0
        np.testing.assert_array_equal(coded.results()[r.uid],
                                      uncoded.results()[r.uid])


def _near_tie_at(rcfg, tree, req, stream, alpha, idx):
    """The reference's top-2 logit gap at generated token ``idx`` of
    ``req`` (teacher-forced on the reference's own stream)."""
    feed = list(req.prompt) + list(stream[:idx])
    cache = RM.init_decode_cache(rcfg, 1, 32)
    for t in feed:
        logits, cache = RM.decode_step(tree, jnp.asarray([t], jnp.int32),
                                       cache, rcfg)
    scores = np.asarray(logits[0, :rcfg.vocab_size], np.float64)
    if idx == 0:
        scores = scores * alpha
    top2 = np.sort(scores)[-2:]
    return top2[1] - top2[0]


@pytest.mark.parametrize("scheme,p", [("expander", 0.3), ("uncoded", 0.3),
                                      ("expander", 0.0)])
def test_engine_streams_match_jax_engine(dense, scheme, p):
    rcfg, tcfg, tree, params = dense
    kw = dict(scheme=scheme, replication=2, straggler_model="bernoulli",
              straggler_p=p, seed=3)
    r_eng, r_sum = _serve(RS, rcfg, tree, _requests(RS, rcfg, 9, 4),
                          RCoding(**kw), log_every=5)
    t_reqs = _requests(TS, tcfg, 9, 4)
    t_eng, t_sum = _serve(TS, tcfg, params, t_reqs, TCoding(**kw),
                          log_every=5)
    for key in ("iterations", "admissions", "retries", "decode_calls",
                "new_tokens", "ttft_p50_ms", "ttft_p99_ms"):
        assert t_sum[key] == r_sum[key], key
    for r in t_reqs:
        rec_t, rec_r = t_eng.records[r.uid], r_eng.records[r.uid]
        for key in ("shard", "alpha", "ttft_ms", "retries",
                    "admitted_iter", "done_iter"):
            assert rec_t[key] == rec_r[key], key
        a, b = t_eng.results()[r.uid], r_eng.results()[r.uid]
        if not np.array_equal(a, b):
            idx = int(np.nonzero(a != b)[0][0])
            gap = _near_tie_at(rcfg, tree, r, b, rec_r["alpha"], idx)
            assert gap < LOGIT_TOL, (
                f"request {r.uid} diverges at token {idx} without a "
                f"near-tie (reference top-2 gap {gap})")


@pytest.mark.parametrize("prompt,new,max_len,window", [
    (8, 8, 16, None), (8, 9, 16, None), (0, 4, 16, None),
    (4, 0, 16, None), (8, 64, 16, 8), (16, 16, 16, None)])
def test_validate_budget_rejects_what_jax_rejects(prompt, new, max_len,
                                                  window):
    rcfg = rget("qwen1.5-4b").smoke_variant()
    tcfg = tget("qwen1.5-4b").smoke_variant()
    if window is not None:
        rcfg = dataclasses.replace(rcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)

    def outcome(mod, cfg):
        try:
            mod.validate_budget(cfg, prompt, new, max_len)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(TS, tcfg) == outcome(RS, rcfg)


def test_cache_pool_reset_zeroes_only_masked_slots(dense):
    _, cfg, _, params = dense
    pool = TS.CachePool(cfg, 4, 16, device="cpu")
    step = TS.pool_step(cfg, cfg.sliding_window)
    _, pool.cache = step(
        params, pool.cache, torch.zeros(4, dtype=torch.int32),
        torch.tensor([3, 1, 4, 1], dtype=torch.int32),
        torch.ones(4, dtype=torch.bool), torch.ones(4))
    before = {k: v.clone() for k, v in pool.cache["layers"].items()}
    pool.reset_slots(np.array([True, False, False, False]))
    for k, old in before.items():
        new = pool.cache["layers"][k]
        assert old.any()
        assert not new[:, 0].any()
        assert torch.equal(new[:, 1:], old[:, 1:])


def test_launch_serve_cli_on_cpu():
    # two torch threads, as the in-process tests: the suite's other
    # workers share the host
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--arch", "granite-3-8b", "--requests", "6",
         "--max-new-tokens", "4", "--check"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["check_passed"] is True
    assert summary["device"] == "cpu"
    assert summary["new_tokens"] == 6 * 4
    assert summary["pool_steps"] > summary["iterations"] > 0
