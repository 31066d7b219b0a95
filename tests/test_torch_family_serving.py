"""Serving the model families through the port, against the JAX package.

- moe, hybrid and ssm go through the continuous-batching engine: the
  port's engine against the reference's on the same carried parameters
  (float32 smoke variants) and the same requests.
- vlm and audio take the static-batch path, as in the reference:
  ``launch.serve.static_generate`` against the reference's
  ``prefill`` / ``encode`` / ``decode_step`` loop on the same carried
  parameters and inputs.

The serve CLI's runs of these families are in
``test_torch_family_serving_cli.py``.

Greedy tokens come from float32 logits that agree to ``LOGIT_TOL``;
streams must be equal unless the reference's top-2 logit gap at the
first differing step is itself below that tolerance (a near-tie, which
then has to be shown), as tests/test_torch_serve.py holds the dense
family.
"""

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
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

LOGIT_TOL = 1e-4
ENGINE = [("deepseek-moe-16b", {}),
          ("zamba2-1.2b", {"n_layers": 4, "attn_positions": (1, 3)}),
          ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1})]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _setup(arch, over):
    rcfg = rget(arch).smoke_variant().with_overrides(**over)
    tcfg = tget(arch).smoke_variant().with_overrides(**over)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tcfg, tree, params_from_numpy(tree, tcfg, device="cpu")


def _requests(mod, cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   6 - (i % 3)),
                        max_new_tokens=4 + (i % 2)) for i in range(n)]


def _serve(mod, cfg, params, reqs, coding):
    eng = mod.ServeEngine(cfg, params, n_slots=4, max_len=32,
                          coding=coding, m_replicas=8, log_every=3)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


def _gap(logits, vocab, alpha=1.0):
    top2 = np.sort(np.asarray(logits, np.float64)[:vocab] * alpha)[-2:]
    return top2[1] - top2[0]


def _near_tie_at(rcfg, tree, prompt, stream, alpha, idx):
    cache = RM.init_decode_cache(rcfg, 1, 32)
    for t in list(prompt) + list(stream[:idx]):
        logits, cache = RM.decode_step(tree, jnp.asarray([t], jnp.int32),
                                       cache, rcfg)
    return _gap(logits[0], rcfg.vocab_size, alpha if idx == 0 else 1.0)


@pytest.mark.parametrize("arch,over", ENGINE, ids=[a for a, _ in ENGINE])
def test_engine_streams_match_jax_engine(arch, over):
    rcfg, tcfg, tree, params = _setup(arch, over)
    kw = dict(scheme="expander", replication=2, straggler_p=0.3, seed=3)
    r_eng, r_sum = _serve(RS, rcfg, tree, _requests(RS, rcfg, 7, 4),
                          RCoding(**kw))
    reqs = _requests(TS, tcfg, 7, 4)
    t_eng, t_sum = _serve(TS, tcfg, params, reqs, TCoding(**kw))
    for key in ("iterations", "admissions", "retries", "decode_calls",
                "new_tokens", "ttft_p50_ms", "ttft_p99_ms"):
        assert t_sum[key] == r_sum[key], key
    ref = TS.sequential_serve(params, tcfg, reqs, n_slots=4, max_len=32)
    for r in reqs:
        a, b = t_eng.results()[r.uid], r_eng.results()[r.uid]
        np.testing.assert_array_equal(a, ref[r.uid])
        if not np.array_equal(a, b):
            idx = int(np.nonzero(a != b)[0][0])
            gap = _near_tie_at(rcfg, tree, r.prompt, b,
                               r_eng.records[r.uid]["alpha"], idx)
            assert gap < LOGIT_TOL, (
                f"request {r.uid} diverges at token {idx} without a "
                f"near-tie (reference top-2 gap {gap})")


def _reference_static(rcfg, tree, prompts, side, max_len, new):
    """The reference's ``_static_main`` loop (src/repro/launch/serve.py:
    53-103) on given parameters and inputs."""
    prefill = RM.prefill(tree, prompts, rcfg, **side)
    src = side.get("src")
    cache = RM.init_decode_cache(
        rcfg, prompts.shape[0], max_len,
        src_len=0 if src is None else src.shape[1])
    if src is not None:
        cache["enc"] = RM.encode(tree, src, rcfg)
    step = jax.jit(lambda p, t, c: RM.decode_step(p, t, c, rcfg))
    for i in range(prompts.shape[1]):
        logits, cache = step(tree, prompts[:, i], cache)
    out, all_logits = [], []
    tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(jnp.int32)
    for _ in range(new):
        out.append(np.asarray(tok))
        all_logits.append(np.asarray(logits))
        logits, cache = step(tree, tok, cache)
        tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(jnp.int32)
    return (np.asarray(prefill), np.asarray(logits), np.stack(out, 1),
            all_logits)


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-large-v2"])
def test_static_path_matches_reference_loop(arch):
    rcfg, tcfg, tree, params = _setup(arch, {})
    B, P, new, max_len = 3, 7, 5, 16
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, rcfg.vocab_size, (B, P)).astype(np.int32)
    stub = (rng.normal(size=(B, rcfg.prefix_len, rcfg.d_model)) *
            0.02).astype(np.float32)
    key = "prefix" if rcfg.arch_type == "vlm" else "src"
    r_pre, r_last, r_tok, r_logits = _reference_static(
        rcfg, tree, prompts, {key: stub}, max_len, new)
    out = tserve.static_generate(
        TM.cast_block_weights(params, tcfg), tcfg, prompts,
        max_len=max_len, max_new_tokens=new,
        **{key: torch.from_numpy(stub)})
    np.testing.assert_allclose(out["prefill_logits"].numpy(), r_pre,
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    t_tok = out["tokens"]
    assert t_tok.shape == (B, new)
    if np.array_equal(t_tok, r_tok):
        np.testing.assert_allclose(out["logits"].numpy(), r_last,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    else:      # only a near-tie of the reference may split the streams
        b, idx = (int(i[0]) for i in np.nonzero(t_tok != r_tok))
        assert _gap(r_logits[idx][b], rcfg.vocab_size) < LOGIT_TOL


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-large-v2"])
def test_engine_refuses_vlm_and_audio_as_the_reference(arch):
    """The pool carries no per-request prefix or source: both engines
    refuse these families (the CLI routes them to the static path)."""
    rcfg, tcfg, tree, params = _setup(arch, {})
    for mod, cfg, p in ((RS, rcfg, tree), (TS, tcfg, params)):
        with pytest.raises(ValueError, match="side channel"):
            mod.ServeEngine(cfg, p, n_slots=2, max_len=8)
