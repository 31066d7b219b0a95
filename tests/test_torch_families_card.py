"""The model families on the card (marker ``cuda``; each test skips
without one): a few training steps and a few teacher-forced decode steps
per family at smoke width, through the kernels and through their plain
versions (``_FORCE = "ref"``), in float32, with exact launch counts.

Imports no JAX: the card's machine has none.

Tolerances, float32. Losses: the first two steps (the forward, then one
AdamW update) within rtol 1e-4 -- the kernels' reduction order -- and all
six within 1e-2, ``chip_smoke.py``'s ``LOSS_RTOL``: at these smoke
configs and lr 3e-3 the recurrent families amplify any rounding
difference step by step (``tools/train_divergence.py`` measures it on
the card: zamba2's 4-layer smoke config parts by several 1e-3 kernels
vs plain in six steps, while both runs repeat bit for bit). Decode
logits atol = rtol = 1e-4.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch import train
from repro_torch.models import model as M

FAMILIES = [("deepseek-moe-16b", {}),
            ("zamba2-1.2b", {"n_layers": 4, "attn_positions": (1, 3)}),
            ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1}),
            ("pixtral-12b", {}),
            ("seamless-m4t-large-v2", {})]
IDS = [a for a, _ in FAMILIES]
STEPS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested here)")
    return torch.device("cuda")


def norms_per_pass(cfg, *, decode: bool) -> int:
    """rmsnorm launches of one forward pass (training batches carry no
    audio source) or one decode step (with the encoder output)."""
    at, L = cfg.arch_type, cfg.n_layers
    if at == "hybrid":
        return L + 2 * len(cfg.attn_positions) + 1
    if at == "ssm":
        return 2 * (L // (cfg.slstm_ratio + 1)) * (cfg.slstm_ratio + 1) + 1
    if at == "audio" and decode:
        return 3 * L + 1
    return 2 * L + 1


def attention_per_step(cfg) -> int:
    if cfg.arch_type == "hybrid":
        return len(cfg.attn_positions)
    return 0 if cfg.arch_type == "ssm" else cfg.n_layers


@contextlib.contextmanager
def _forced(force):
    rn_ops._FORCE = da_ops._FORCE = force
    rn_ops.launches = da_ops.launches = 0
    try:
        yield
    finally:
        rn_ops._FORCE = da_ops._FORCE = None


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_family_train_steps_on_card(cuda, arch, over):
    cfg = get_config(arch).smoke_variant().with_overrides(**over)
    argv = ["--steps", str(STEPS), "--seq-len", "32", "--block-size", "2",
            "--log-every", "1", "--seed", "0"]
    out = {}
    for force in (None, "ref"):
        with _forced(force), contextlib.redirect_stdout(io.StringIO()):
            out[force] = train.main(argv, cfg=cfg)
            launches = rn_ops.launches
        if force is None:
            assert launches == norms_per_pass(cfg, decode=False) * STEPS
        else:
            assert launches == 0
    got, want = out[None]["losses"], out["ref"]["losses"]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_family_decode_kernels_vs_plain_on_card(cuda, arch, over):
    cfg = get_config(arch).smoke_variant().with_overrides(**over)
    params = M.init_params(cfg, seed=1, device=cuda)
    B, steps = 3, 4
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (steps, B))).to(cuda)
    src = None
    if cfg.arch_type == "audio":
        src = torch.randn(B, cfg.prefix_len, cfg.d_model, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(3))
    logits = {}
    for force in (None, "ref"):
        with _forced(force), torch.no_grad():
            cache = M.init_decode_cache(
                cfg, B, 16, device=cuda,
                src_len=0 if src is None else src.shape[1])
            if src is not None:
                cache["enc"] = M.encode(params, src * 0.02, cfg)
            rn_ops.launches = 0
            logits[force] = torch.stack([
                M.decode_step(params, toks[t], cache, cfg)[0]
                for t in range(steps)])
            counts = (rn_ops.launches, da_ops.launches)
        want = ((norms_per_pass(cfg, decode=True) * steps,
                 attention_per_step(cfg) * steps) if force is None
                else (0, 0))
        assert counts == want
    torch.cuda.synchronize()
    np.testing.assert_allclose(logits[None].cpu().numpy(),
                               logits["ref"].cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
