"""The port's model families against the JAX package on the serving
path: ``decode_step`` over a teacher-forced token stream (with the
families' caches: KV, SSM + KV, xLSTM states, the audio encoder
output), ``prefill`` with the vlm prefix and the audio source, and the
reference suite's own identity (tests/test_models.py:82-133) on the
port: decoding a prompt step by step reproduces the full forward.

Parameters cross from the reference through NumPy; float32 smoke
variants (xLSTM at 4 layers, 1:1, so that it has super-blocks).
Tolerances: port against reference, atol = rtol = 1e-4 on logits and
caches (float32 reduction order); decode against forward inside the
port, 2e-3 (the reference test's: the chunked and the step-by-step
recurrences sum in different orders). MoE is left out of that identity,
as in the reference: decode routes with capacity E / top_k, so every
expert takes the token, where the forward's experts choose among S.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.dist import coded_train as RT
from repro.models import model as RM
from repro_torch import tree as T
from repro_torch.configs import get_config as tget
from repro_torch.dist import coded_train as TT
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
B, STEPS, MAX_LEN = 2, 6, 16

FAMILIES = [
    ("deepseek-moe-16b", {}),
    ("llama4-scout-17b-a16e", {"sliding_window": 4}),   # the cache wraps
    ("zamba2-1.2b", {"n_layers": 4, "attn_positions": (1, 3)}),
    ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1}),
    ("pixtral-12b", {}),
    ("seamless-m4t-large-v2", {}),
]
IDS = [a for a, _ in FAMILIES]


def _setup(arch, over):
    rcfg = rget(arch).smoke_variant().with_overrides(**over)
    tcfg = tget(arch).smoke_variant().with_overrides(**over)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tcfg, tree, params_from_numpy(tree, tcfg, device="cpu")


def _stub(cfg, seed=2):
    return (np.random.default_rng(seed).normal(
        size=(B, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_decode_steps_match_reference(arch, over):
    rcfg, tcfg, tree, params = _setup(arch, over)
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (STEPS, B)).astype(np.int32)
    src_len = rcfg.prefix_len if rcfg.arch_type == "audio" else 0
    rcache = RM.init_decode_cache(rcfg, B, MAX_LEN, src_len=src_len)
    tcache = TM.init_decode_cache(tcfg, B, MAX_LEN, src_len=src_len,
                                  device="cpu")
    rflat = dict(zip(*T.flatten(jax.tree.map(np.asarray, rcache))))
    tflat = dict(zip(*T.flatten(tcache)))
    assert rflat.keys() == tflat.keys()
    for k, a in rflat.items():
        assert tuple(tflat[k].shape) == a.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == str(a.dtype), k
    if rcfg.arch_type == "audio":
        src = _stub(rcfg)
        rcache["enc"] = RM.encode(tree, src, rcfg)
        tcache["enc"] = TM.encode(params, torch.from_numpy(src), tcfg)
        _close(tcache["enc"], rcache["enc"])
    step = jax.jit(lambda p, t, c: RM.decode_step(p, t, c, rcfg))
    for t in range(STEPS):
        rl, rcache = step(tree, toks[t], rcache)
        tl, tcache = TM.decode_step(params, torch.from_numpy(toks[t]),
                                    tcache, tcfg)
        assert tl.shape == (B, tcfg.padded_vocab())
        _close(tl, rl)
    rflat = dict(zip(*T.flatten(jax.tree.map(np.asarray, rcache))))
    for k, v in zip(*T.flatten(tcache)):
        _close(v, rflat[k])


@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_prefill_matches_reference_and_forward(arch, over):
    """``make_prefill_step`` with the family's side input, against the
    reference's, and against the port's own forward at the last
    position (the reference test's 2e-4)."""
    rcfg, tcfg, tree, params = _setup(arch, over)
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (B, 10)).astype(np.int32)
    batch = {"tokens": toks}
    if rcfg.arch_type == "vlm":
        batch["prefix"] = _stub(rcfg)
    if rcfg.arch_type == "audio":
        batch["src"] = _stub(rcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = RT.make_prefill_step(rcfg)(tree, batch)
    got = TT.make_prefill_step(tcfg)(params, tb)
    assert got.shape == (B, tcfg.padded_vocab())
    _close(got, want)
    full = TM.forward(params, tb["tokens"], tcfg, prefix=tb.get("prefix"),
                      src=tb.get("src"))[:, -1]
    _close(got, full.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch,over", [f for f in FAMILIES
                                       if f[0] != "deepseek-moe-16b"
                                       and "llama4" not in f[0]],
                         ids=[a for a in IDS if "moe" not in a
                              and "llama4" not in a])
def test_decode_reproduces_forward_teacher_forcing(arch, over):
    _, tcfg, _, params = _setup(arch, over)
    S = 9
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, S)))
    src = torch.from_numpy(_stub(tcfg)[:1]) \
        if tcfg.arch_type == "audio" else None
    full = TM.forward(params, toks, tcfg, src=src)
    cache = TM.init_decode_cache(tcfg, 1, S, device="cpu",
                                 src_len=0 if src is None else src.shape[1])
    if src is not None:
        cache["enc"] = TM.encode(params, src, tcfg)
    dec = torch.stack([TM.decode_step(params, toks[:, t], cache, tcfg)[0]
                       for t in range(S)], dim=1)
    _close(dec, full.numpy(), atol=2e-3, rtol=2e-3)
