"""Activation rematerialisation in the port's training forward.

Every family's smoke config (the families' parametrisation of
tests/test_torch_families.py), with remat on and off (the model's
``_REMAT`` test hook), on the CPU under
``torch.use_deterministic_algorithms(True)``:

- the training loss and every gradient leaf are bit for bit equal:
  the recomputed forward is the same arithmetic on the same inputs;
- remat sits where the reference's ``jax.checkpoint`` sits
  (``repro/models/model.py`` ``_scan_blocks`` and the xLSTM super-block):
  the rmsnorm calls of one forward and backward count each recomputed
  layer's norms once more (each mLSTM layer's twice more: it is
  recomputed inside its recomputed super-block), the hybrid's shared
  attention and the final norm not at all;
- under no grad (prefill, decoding) nothing is recomputed.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.dist import coded_train as TT
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import model as TM

FAMILIES = [
    ("qwen1.5-4b", {}),                           # dense
    ("deepseek-moe-16b", {}),                     # moe
    ("zamba2-1.2b", {"n_layers": 4, "attn_positions": (1, 3)}),
    ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1}),
    ("pixtral-12b", {}),                          # vlm
    ("seamless-m4t-large-v2", {}),                # audio
]
IDS = [a for a, _ in FAMILIES]


@pytest.fixture(scope="module", autouse=True)
def _deterministic_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _remat(on: bool):
    TM._REMAT = on
    try:
        yield
    finally:
        TM._REMAT = True


@contextlib.contextmanager
def _count_norms(monkeypatch):
    calls = []
    plain = rn_ops._forward
    monkeypatch.setattr(rn_ops, "_forward",
                        lambda *a: calls.append(1) or plain(*a))
    yield calls
    monkeypatch.setattr(rn_ops, "_forward", plain)


def _batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = toks.copy()
    labels[0, -3:] = -1
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    stub = torch.from_numpy(
        rng.normal(size=(B, cfg.prefix_len, cfg.d_model)) * 0.02).float()
    if cfg.arch_type == "vlm":
        batch["prefix"] = stub
    if cfg.arch_type == "audio":
        batch["src"] = stub
    return batch


def _norms(cfg, *, grad: bool) -> int:
    """rmsnorm calls of one forward (and, with ``grad``, its backward's
    recomputation) over a batch with the family's side input."""
    at, L, r = cfg.arch_type, cfg.n_layers, cfg.slstm_ratio
    if at == "hybrid":
        fwd, again = L + 2 * len(cfg.attn_positions) + 1, L
    elif at == "ssm":
        n_super = L // (r + 1)
        fwd = 2 * (r + 1) * n_super + 1
        again = 2 * (r + 1) * n_super + 2 * r * n_super
    elif at == "audio":
        enc = cfg.n_encoder_layers
        fwd, again = 2 * enc + 1 + 3 * L + 1, 2 * enc + 3 * L
    else:
        fwd, again = 2 * L + 1, 2 * L
    return fwd + (again if grad else 0)


@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_remat_is_bitwise_and_where_the_reference_puts_it(arch, over,
                                                         monkeypatch):
    cfg = get_config(arch).smoke_variant().with_overrides(**over)
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    out = {}
    for on in (False, True):
        with _remat(on), _count_norms(monkeypatch) as calls:
            loss, grads = TT.value_and_grad(
                lambda p: TM.train_loss(p, batch, cfg), params)
        out[on] = (loss, T.leaves(grads), len(calls))
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) and all(torch.equal(a, b)
                                      for a, b in zip(g0, g1))
    assert n0 == _norms(cfg, grad=False)
    assert n1 == _norms(cfg, grad=True)
    with torch.no_grad(), _count_norms(monkeypatch) as calls:
        TM.forward(params, batch["tokens"], cfg,
                   prefix=batch.get("prefix"), src=batch.get("src"))
    assert len(calls) == _norms(cfg, grad=False)
