"""The port's model families (moe, hybrid, ssm, vlm, audio) against the
JAX package: parameter layout, full-sequence logits, the training loss
and every gradient leaf.

Each family runs at its reference ``smoke_variant()`` in float32; the
reference's parameters (``jax.random``) cross into the port through
NumPy (``convert.params_from_numpy``), and inputs are made with NumPy
from a seed. xLSTM's smoke variant has 2 layers at a 7:1 ratio, so no
super-block at all; it runs at 4 layers with a 1:1 ratio (two
super-blocks), and zamba2 also with two shared-attention insertions.

Tolerances, float32, the two libraries' reduction orders: logits
atol = rtol = 1e-4; the loss (summed per sequence, and over the batch
normalised by the label count, as the coded losses are) rtol 1e-5;
every gradient leaf of the normalised loss rtol 2e-4 / atol 2e-5 (the
reference's own ``_tree_allclose``, as tests/test_torch_train.py holds
the dense family), the atol scaled by max(1, max |leaf|): the embedding
table's gradient reaches ~9 here (the first norm divides 0.02-scale
embeddings by their rms, so it multiplies their cotangent by ~50), and
float32 rounding scales with it. Gradients of
parameters the loss does not read (the audio encoder on a batch without
``src``) are zeros in both, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch import tree as T
from repro_torch.configs import get_config as tget
from repro_torch.dist import coded_train as TT
from repro_torch.models import model as TM
from repro_torch.models.convert import param_shapes, params_from_numpy

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

# (arch, overrides of the smoke variant)
FAMILIES = [
    ("deepseek-moe-16b", {}),                     # moe, 2 shared experts
    ("llama4-scout-17b-a16e", {}),                # moe, top-1, window
    ("zamba2-1.2b", {}),                          # hybrid, one insertion
    ("zamba2-1.2b", {"n_layers": 4, "attn_positions": (1, 3)}),
    ("xlstm-1.3b", {"n_layers": 4, "slstm_ratio": 1}),
    ("pixtral-12b", {}),                          # vlm
    ("seamless-m4t-large-v2", {}),                # audio
]
IDS = [f"{a}{'-' + str(len(o)) if o else ''}" for a, o in FAMILIES]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, over):
    return (rget(arch).smoke_variant().with_overrides(**over),
            tget(arch).smoke_variant().with_overrides(**over))


def _setup(arch, over, seed=0):
    rcfg, tcfg = _cfgs(arch, over)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    return rcfg, tcfg, tree, params_from_numpy(tree, tcfg, device="cpu")


def _batch(cfg, B=2, S=20, seed=1, side=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, -3:] = -1                       # padded label positions
    batch = {"tokens": toks, "labels": labels}
    stub = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model)) *
            0.02).astype(np.float32)
    if side and cfg.arch_type == "vlm":
        batch["prefix"] = stub
    if side and cfg.arch_type == "audio":
        batch["src"] = stub
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_close(got, want, key):
    atol = GRAD_TOL["atol"] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL["rtol"],
                               atol=atol, err_msg=key)


# The loss normalised by the label count, as the coded losses are.
def _ref_loss(batch, cfg):
    norm = batch["labels"].size
    return lambda p: RM.train_loss(p, batch, cfg, per_example=True).sum() \
        / norm


def _port_loss(batch, cfg):
    norm = batch["labels"].numel()
    return lambda p: TM.train_loss(p, batch, cfg, per_example=True).sum() \
        / norm


@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_param_layout_matches_reference(arch, over):
    rcfg, tcfg = _cfgs(arch, over)
    ref = jax.tree.map(np.asarray,
                       RM.init_params(rcfg, jax.random.PRNGKey(0)))
    port = TM.init_params(tcfg, device="cpu")
    rflat = dict(zip(*T.flatten(ref)))
    pflat = dict(zip(*T.flatten(port)))
    assert rflat.keys() == pflat.keys() == param_shapes(tcfg).keys()
    for k, a in rflat.items():
        assert tuple(pflat[k].shape) == a.shape, k
        assert str(pflat[k].dtype).split(".")[-1] == str(a.dtype), k


@pytest.mark.parametrize("arch,over", FAMILIES, ids=IDS)
def test_forward_loss_and_grads_match_reference(arch, over):
    """With the family's side input (the vlm prefix, the audio source):
    logits over every position, the loss over the token positions only,
    and every gradient leaf."""
    rcfg, tcfg, tree, params = _setup(arch, over)
    batch = _batch(rcfg)
    tb = _torch(batch)
    want = np.asarray(RM.forward(tree, batch["tokens"], rcfg,
                                 prefix=batch.get("prefix"),
                                 src=batch.get("src")))
    got = TM.forward(params, tb["tokens"], tcfg, prefix=tb.get("prefix"),
                     src=tb.get("src"))
    P = rcfg.prefix_len if rcfg.arch_type == "vlm" else 0
    assert got.dtype == torch.float32
    assert got.shape == (2, 20 + P, tcfg.padded_vocab()) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)

    rloss, rgrads = jax.jit(jax.value_and_grad(_ref_loss(batch, rcfg)))(
        tree)
    tloss, tgrads = TT.value_and_grad(_port_loss(tb, tcfg), params)
    np.testing.assert_allclose(tloss.item(), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(
        TM.train_loss(params, tb, tcfg, per_example=True).numpy(),
        np.asarray(RM.train_loss(tree, batch, rcfg, per_example=True)),
        rtol=1e-5)
    rflat = dict(zip(*T.flatten(jax.tree.map(np.asarray, rgrads))))
    tflat = dict(zip(*T.flatten(tgrads)))
    assert rflat.keys() == tflat.keys()
    for k, g in rflat.items():
        _grad_close(tflat[k], g, k)


def test_audio_encoder_gets_zero_gradients_without_src():
    """Training batches carry no ``src``: the decoder skips its
    cross-attention, and the encoder, ``enc_norm`` and the cross
    weights get exact zeros, as ``jax.grad`` gives them."""
    rcfg, tcfg, tree, params = _setup("seamless-m4t-large-v2", {})
    batch = _batch(rcfg, side=False)
    rgrads = jax.jit(jax.grad(_ref_loss(batch, rcfg)))(tree)
    _, tgrads = TT.value_and_grad(_port_loss(_torch(batch), tcfg), params)
    rflat = dict(zip(*T.flatten(jax.tree.map(np.asarray, rgrads))))
    tflat = dict(zip(*T.flatten(tgrads)))
    unused = sorted(k for k in rflat if k.startswith(("encoder/",
                                                      "enc_norm/"))
                    or "/cross/" in k or "/ln_cross/" in k)
    assert len(unused) == 15
    for k in unused:
        assert not np.any(rflat[k]) and not torch.any(tflat[k]), k
        assert tuple(tflat[k].shape) == rflat[k].shape, k
    for k in rflat:
        if k not in unused:
            _grad_close(tflat[k], rflat[k], k)


@pytest.mark.parametrize("codec", ["int8", "sign", "sign_packed"])
def test_codecs_take_an_all_zero_leaf_as_the_reference(codec):
    """The compressed paths quantize every gradient row, the audio
    encoder's zeros too: both packages' codecs give a zero payload and
    a zero decompressed row."""
    from repro.core import compress as rcomp
    from repro_torch.core import compress as tcomp
    import jax.numpy as jnp
    g = np.zeros((3, 17), np.float32)
    rq, rs = rcomp.get_codec(codec).compress(jnp.asarray(g))
    tq, ts = tcomp.get_codec(codec).compress(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    back = tcomp.get_codec(codec).decompress(tq, ts, 17)
    assert not back.any()


def test_unknown_arch_type_raises():
    cfg = tget("granite-3-8b").smoke_variant().with_overrides(
        arch_type="rnn")
    for call in (lambda: TM.init_params(cfg, device="cpu"),
                 lambda: TM.init_decode_cache(cfg, 1, 4, device="cpu"),
                 lambda: TM.forward_hidden({}, torch.zeros(1, 2).long(),
                                           cfg),
                 lambda: param_shapes(cfg)):
        with pytest.raises(ValueError, match="unknown arch_type"):
            call()
