"""The port's dense decode path against ``repro.models.model`` (the other
families: tests/test_torch_families*.py).

The JAX package's parameters cross into the port through NumPy
(``repro_torch.models.convert.params_from_numpy``); both packages then
decode the same teacher-forced token stream (made with NumPy from a
seed) for 8 steps and the logits are compared at every step.

Tolerances. float32: ``atol = rtol = 1e-4`` -- the two libraries run
the same float32 arithmetic in different reduction orders (matmul
blocking, softmax sums), which moves logits of order 1 by ~1e-6 per
layer. bfloat16 (activations and cache in bf16, as the full configs
run): ``atol = rtol = 5e-2`` -- a reduction-order difference can flip
the rounding of a bf16 activation (one ulp is 2^-8 ~ 4e-3 relative),
and such flips carry through the residual stream to the logits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
B, STEPS = 3, 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **over):
    return (rget(arch).smoke_variant().with_overrides(**over),
            tget(arch).smoke_variant().with_overrides(**over))


def _jax_params(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))


def _teacher_forced(rcfg, tcfg, tree, max_len=16, steps=STEPS):
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (steps, B)).astype(np.int32)
    params = params_from_numpy(tree, tcfg, device="cpu")
    rcache = RM.init_decode_cache(rcfg, B, max_len)
    tcache = TM.init_decode_cache(tcfg, B, max_len, device="cpu")
    step = jax.jit(lambda p, t, c: RM.decode_step(p, t, c, rcfg))
    out = []
    for t in range(steps):
        rl, rcache = step(tree, tokens[t], rcache)
        tl, tcache = TM.decode_step(params, torch.from_numpy(tokens[t]),
                                    tcache, tcfg)
        out.append((np.asarray(rl, np.float32), tl.float().numpy()))
    return out, rcache, tcache


@pytest.mark.parametrize("arch,over", [
    ("qwen1.5-4b", {}),                      # QKV bias, G = 1
    ("granite-3-8b", {"n_kv_heads": 2}),     # GQA, G = 2
    ("granite-3-8b", {"n_kv_heads": 2, "sliding_window": 4}),  # wraps
])
def test_decode_step_logits_match_jax_float32(arch, over):
    rcfg, tcfg = _cfgs(arch, **over)
    assert rcfg.dtype == "float32"
    out, rcache, tcache = _teacher_forced(rcfg, tcfg, _jax_params(rcfg))
    for rl, tl in out:
        assert tl.shape == (B, tcfg.padded_vocab())
        np.testing.assert_allclose(tl, rl, **F32_TOL)
    lay = tcache["layers"]
    np.testing.assert_array_equal(lay["pos"].numpy(),
                                  np.asarray(rcache["layers"]["pos"]))
    np.testing.assert_allclose(lay["k"].numpy(),
                               np.asarray(rcache["layers"]["k"]),
                               **F32_TOL)


def test_decode_step_logits_match_jax_bfloat16():
    rcfg, tcfg = _cfgs("granite-3-8b", n_kv_heads=2, dtype="bfloat16")
    out, _, _ = _teacher_forced(rcfg, tcfg, _jax_params(rcfg))
    for rl, tl in out:
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tl, rl, **BF16_TOL)


@pytest.mark.parametrize("arch,over", [
    ("granite-3-8b", {"n_kv_heads": 2}),
    ("deepseek-moe-16b", {}),
    ("zamba2-1.2b", {}),
    ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1}),
    ("pixtral-12b", {}),
    ("seamless-m4t-large-v2", {}),
])
def test_cast_block_weights_leaves_logits_bit_identical(arch, over):
    """Casting block weights once (the engine's choice) is the per-call
    ``w.to(x.dtype)`` of ``linear`` (and of the expert weights and the
    SSM's conv filter) done up front: same bits, in every family. The
    SSM's A_log, dt_bias and D stay float32, as the reference reads
    them."""
    _, tcfg = _cfgs(arch, dtype="bfloat16", **over)
    params = TM.init_params(tcfg, seed=3, device="cpu")
    cast = TM.cast_block_weights(params, tcfg)
    flat = dict(_leaves(cast))
    for key, leaf in flat.items():
        parts = key.split("/")
        f32 = (parts[0] in ("embed", "final_norm", "lm_head", "enc_norm")
               or parts[-2].startswith("ln")
               or parts[-1] in ("A_log", "dt_bias", "D"))
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), key
    tok = torch.tensor([1, 5, 7])
    src_len = 8 if tcfg.arch_type == "audio" else 0
    c1 = TM.init_decode_cache(tcfg, 3, 8, src_len=src_len, device="cpu")
    c2 = TM.init_decode_cache(tcfg, 3, 8, src_len=src_len, device="cpu")
    if src_len:
        src = torch.randn(3, src_len, tcfg.d_model,
                          generator=torch.Generator().manual_seed(0)) * 0.02
        c1["enc"] = TM.encode(params, src, tcfg)
        c2["enc"] = TM.encode(cast, src, tcfg)
        assert torch.equal(c1["enc"], c2["enc"])
    for _ in range(3):
        l1, c1 = TM.decode_step(params, tok, c1, tcfg)
        l2, c2 = TM.decode_step(cast, tok, c2, tcfg)
        assert torch.equal(l1, l2)
        tok = l1.argmax(-1)


def test_params_from_checkpoint_npz(tmp_path):
    rcfg, tcfg = _cfgs("qwen1.5-4b")
    tree = _jax_params(rcfg, seed=1)
    path = rckpt.save(str(tmp_path), tree, step=0)
    a = params_from_numpy(path, tcfg, device="cpu")
    b = params_from_numpy(tree, tcfg, device="cpu")
    flat_a = dict(_leaves(a))
    flat_b = dict(_leaves(b))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k


def test_params_from_numpy_rejects_wrong_tree():
    rcfg, tcfg = _cfgs("granite-3-8b", n_kv_heads=2)
    tree = _jax_params(rcfg)
    other = dataclasses.replace(tcfg, n_kv_heads=4)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, other, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_port_init_params_matches_reference_layout():
    rcfg, tcfg = _cfgs("qwen1.5-4b")
    ref = dict(_leaves(_jax_params(rcfg)))
    port = dict(_leaves(TM.init_params(tcfg, device="cpu")))
    assert ref.keys() == port.keys()
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape, k
        assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree
