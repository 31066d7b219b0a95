"""``launch.step_analysis`` against the reference's HLO analysis, and the
meta-device routing of the kernel dispatchers.

- Prefill at the qwen1.5-4b smoke config: the port's matmul FLOPs and
  dot bytes equal ``hlo_analysis.analyze`` of the reference's jitted
  CPU prefill.
- The coded train step (replicated, 2 microbatches, the reference's
  ``tests/test_system.py`` dry-run shape): both rematerialise each layer
  (``jax.checkpoint``; ``torch.utils.checkpoint``), and both recompute
  all of a layer's forward but the MLP's down projection, whose output
  the backward never reads (XLA drops it; torch's non-reentrant
  checkpoint stops its recomputation at the last tensor the backward
  needs). The port's count is the reference's plus one Q K^T product a
  tile: the flash-attention backward recomputes the scores, where the
  reference's scan saves them. The dedup step is the replicated one
  over m * load / n fewer sequences.
- A train step of k microbatches counts k times a one-microbatch step
  on one microbatch's blocks (what the dry-run relies on).
- Every family's train, prefill and decode steps run on meta tensors:
  no kernel launches, nothing is allocated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CodingConfig as RCoding
from repro.configs import get_config as r_get_config
from repro.configs.base import ShapeSpec as RShape
from repro.dist import coded_train as r_ct
from repro.launch import hlo_analysis
from repro.launch import specs as r_specs
from repro.launch.mesh import make_test_mesh
from repro.models import model as RM
from repro.optim import optimizers as r_opt
from repro_torch.configs import CodingConfig, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import coded_train as ct
from repro_torch.kernels.batched_alpha import ops as ba_ops
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.spectral_matvec import ops as sm_ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch import step_analysis as sa
from repro_torch.launch.mesh import make_test_layout
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

TINY = ("tiny_train", 32, 8, "train")


def _launches():
    return (rn_ops.launches, da_ops.launches, dict(cc_ops.launches),
            ba_ops.launches, dict(sm_ops.launches))


def test_prefill_flops_equal_the_reference_hlo_count():
    cfg, r_cfg = (get_config("qwen1.5-4b").smoke_variant(),
                  r_get_config("qwen1.5-4b").smoke_variant())
    B, S = 2, 32
    params = RM.init_params(r_cfg, jax.random.PRNGKey(0))
    compiled = jax.jit(r_ct.make_prefill_step(r_cfg)).lower(
        params, {"tokens": jnp.zeros((B, S), jnp.int32)}).compile()
    ref = hlo_analysis.analyze(compiled.as_text())
    got = sa.analyze(ct.make_prefill_step(cfg), specs.meta_params(cfg),
                     {"tokens": specs.meta((B, S), torch.int32)})
    assert got["flops"] == ref["flops"] > 0
    assert got["dot_bytes"] == ref["dot_bytes"] > 0
    assert got["collective_bytes"] == ref["collective_bytes"] == 0
    assert got["materialised_bytes"] == 0


def test_train_flops_equal_the_reference_plus_the_flash_qk_recompute():
    cfg = get_config("qwen1.5-4b").smoke_variant()
    r_cfg = r_get_config("qwen1.5-4b").smoke_variant()
    mesh = make_test_mesh((1, 1))
    r_spec = r_specs.make_step_spec(r_cfg, RShape(*TINY), mesh,
                                    RCoding(replication=2))
    r_fn = r_ct.make_train_step(r_cfg, r_opt.get_optimizer("adamw", 1e-4),
                                n_microbatches=2)
    with mesh:
        compiled = jax.jit(r_fn, in_shardings=r_spec.in_shardings,
                           out_shardings=r_spec.out_shardings).lower(
            *r_spec.args).compile()
    ref = hlo_analysis.analyze(compiled.as_text())

    spec = specs.make_step_spec(cfg, ShapeSpec(*TINY), make_test_layout(),
                                CodingConfig(replication=2))
    opt = opt_mod.get_optimizer("adamw", 1e-4)
    port = sa.analyze(ct.make_train_step(cfg, opt, n_microbatches=2),
                      *spec.args)
    m, load, bs, S = spec.args[2]["tokens"].shape
    # one (S x S) tile a sequence (S <= the 512 blocks), every layer;
    # a lone tile holds each row's own key, so none is wholly hidden and
    # skipped, and the counts differ by the recompute alone
    qk = cfg.n_layers * 2 * (m * load * bs) * cfg.n_heads * S * S \
        * cfg.head_dim
    assert port["flops"] == ref["flops"] + qk

    # the recomputation is the forward less the MLP down projection
    M._REMAT = False
    try:
        kept = sa.analyze(ct.make_train_step(cfg, opt, n_microbatches=2),
                          *spec.args)
    finally:
        M._REMAT = True
    x = specs.meta((m * load * bs, S, cfg.d_model), cfg.dtype)
    with torch.no_grad():
        forward = sa.analyze(
            lambda p, x: M._backbone(p, x, cfg, window=None),
            spec.args[0], x)["flops"]
    mlp_down = cfg.n_layers * 2 * m * load * bs * S * cfg.d_ff \
        * cfg.d_model
    assert port["flops"] - kept["flops"] == forward - mlp_down > 0

    # dedup: each of the n unique blocks once instead of m * load rows
    n = 2 * m // 2
    blocks = {k: specs.meta((n, bs, S), torch.int32)
              for k in ("tokens", "labels")}
    dedup = sa.analyze(ct.make_train_step(cfg, opt, n_microbatches=2,
                                          dedup=True),
                       spec.args[0], spec.args[1], blocks,
                       specs.meta((n,), torch.float32))
    assert dedup["flops"] * (m * load // n) == port["flops"]


@pytest.mark.parametrize("k", [2, 4])
def test_microbatches_count_k_times_one(k):
    cfg = get_config("granite-3-8b").smoke_variant()
    params = specs.meta_params(cfg)
    opt = opt_mod.get_optimizer("adamw", 1e-4)
    state = opt.init(params)
    n, bs, S = 4, 8, 16

    def run(nm, rows):
        blocks = {key: specs.meta((n, rows, S), torch.int32)
                  for key in ("tokens", "labels")}
        return sa.analyze(ct.make_train_step(cfg, opt, n_microbatches=nm,
                                             dedup=True),
                          params, state, blocks,
                          specs.meta((n,), torch.float32))
    whole, one = run(k, bs), run(1, bs // k)
    assert whole["flops"] == k * one["flops"] > 0
    assert whole["dot_bytes"] == k * one["dot_bytes"]
    assert whole["dot_calls"] == k * one["dot_calls"]


FAMILIES = ("qwen1.5-4b", "deepseek-moe-16b", "zamba2-1.2b", "xlstm-1.3b",
            "pixtral-12b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_step_runs_on_meta(arch):
    cfg = get_config(arch).smoke_variant()
    if arch == "xlstm-1.3b":
        cfg = cfg.with_overrides(n_layers=4, slstm_ratio=1)
    layout = make_test_layout((2, 1))
    before = _launches()
    for shape in (ShapeSpec("t", 64, 8, "train"),
                  ShapeSpec("p", 64, 2, "prefill"),
                  ShapeSpec("d", 64, 2, "decode")):
        fn, args, spec, trips = dryrun.build_step(
            cfg, shape, layout, CodingConfig(replication=2),
            microbatches=2 if shape.kind == "train" else 1)
        with torch.no_grad():
            stats = sa.analyze(fn, *args)
        assert stats["flops"] > 0 and stats["dot_bytes"] > 0, shape.kind
        assert stats["materialised_bytes"] == 0, shape.kind
    assert _launches() == before


def test_comm_is_the_codec_payload():
    cfg = get_config("qwen1.5-4b").smoke_variant()
    params = specs.meta_params(cfg)
    n_params = sum(int(np.prod(p.shape)) for p in
                   jax.tree_util.tree_leaves(params))
    assert sa.comm(None, 4, params) == {"none": 4 * 4 * n_params}
    packed = sa.comm("sign_packed", 2, params)["sign_packed"]
    assert packed < 2 * n_params
    stats = sa.analyze(lambda: None, comm=sa.comm("int8", 1, params))
    assert stats["collectives"] == sa.comm("int8", 1, params)
    assert stats["collective_bytes"] == sum(stats["collectives"].values())
    assert stats["flops"] == 0


def test_dispatchers_route_meta_tensors_to_the_plain_versions():
    before = _launches()
    x = specs.meta((3, 5, 64), torch.bfloat16)
    out = rn_ops.rmsnorm(x, specs.meta((64,), torch.float32))
    assert out.device.type == "meta" and out.shape == x.shape
    q = specs.meta((2, 8, 32), torch.float32)
    kv = specs.meta((2, 16, 2, 32), torch.float32)
    lens = specs.meta((2,), torch.int32)
    assert da_ops.decode_attention(q, kv, kv, lens).shape == (2, 8, 32)
    g, w = specs.meta((4, 100), torch.float32), specs.meta((4,),
                                                          torch.float32)
    assert cc_ops.coded_combine(g, w).shape == (100,)
    q8 = specs.meta((4, 100), torch.int8)
    assert cc_ops.quantized_combine(q8, w, w).shape == (100,)
    qp = specs.meta((4, 13), torch.uint8)
    assert cc_ops.packed_sign_combine(qp, w, w, 100).shape == (100,)
    xs = specs.meta((50, 7), torch.float32)
    assert sm_ops.gram_matvec(xs, np.ones(7)).shape == (7,)
    assert sm_ops.gram_matvec_batch(
        specs.meta((3, 50, 7), torch.float32), np.ones((3, 7))).shape == \
        (3, 7)
    errs, scale = ba_ops.fused_error(np.ones((5, 6)), device="meta")
    assert errs.device.type == "meta" and errs.shape == (5,)
    assert scale == 1.0
    assert _launches() == before
