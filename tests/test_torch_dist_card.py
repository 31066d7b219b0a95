"""The distributed runtime on the card: one ``nccl`` rank, in process.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one;
the multi-rank algebra is pinned on the CPU over ``gloo``
(``test_torch_dist_groups.py``, ``test_torch_dist_driver.py``).

- The streaming manual step (chunk 1 and 2) equals the materialising
  one at the smoke size through the kernels: one SGD step's combined
  gradient within rtol 2e-4 / atol 2e-5 (the reference's reassociation
  tolerance), and ``coded_combine`` launched once a leaf and chunk.
- Streaming holds less: its peak ``torch.cuda.max_memory_allocated``
  is strictly under the materialising step's.
- The group is the default ``nccl`` group of one rank, and the training CLI's
  summary reports ``world_size`` 1.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import CodingConfig, get_config
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import coded_train as TT
from repro_torch.dist import process_group as pg
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.models import model as M
from repro_torch.models.convert import param_shapes
from repro_torch.optim import optimizers as opt_mod


@pytest.fixture
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: nccl and the CUDA kernels have "
                    "no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    formed = dist.is_initialized()
    if not formed:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    try:
        yield dev
    finally:
        if not formed:
            dist.destroy_process_group()


def _inputs(dev, cfg):
    A = TT.make_assignment(CodingConfig(replication=2), 4)
    raw = SyntheticLM(cfg.vocab_size, 32, seed=0).batch(A.n * 2, 0)
    coded = {k: torch.from_numpy(v).to(dev) for k, v in
             CodedBatcher(A, shuffle_seed=0).code_batch(raw).items()}
    return coded, torch.tensor([1.0, 0.0, 0.7, 2.0], device=dev)


@pytest.mark.cuda
def test_streaming_equals_materialising_on_one_nccl_rank(nccl_rank):
    dev = nccl_rank
    workers = pg.init_workers(dev)
    assert workers.size == 1 and dist.get_backend() == "nccl"
    cfg = get_config("granite-3-8b").smoke_variant()
    coded, w = _inputs(dev, cfg)
    params = M.init_params(cfg, seed=1, device=dev)
    lr = 1e-2
    opt = opt_mod.sgd(lr)
    n_leaves = len(param_shapes(cfg))
    grads, peaks = {}, {}
    for chunk in (None, 1, 2):
        step = TT.make_manual_collective_train_step(
            cfg, opt, streaming_chunk=chunk, workers=workers)
        cc_ops.launches = dict.fromkeys(cc_ops.launches, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            p, _, _ = step(params, opt.init(params), coded, w)
        torch.cuda.synchronize()
        peaks[chunk] = torch.cuda.max_memory_allocated() - base
        assert cc_ops.launches["coded_combine"] == \
            n_leaves * (4 // (chunk or 4))
        grads[chunk] = [((a - b) / -lr).cpu()
                        for a, b in zip(T.leaves(p), T.leaves(params))]
        del p
    for chunk in (1, 2):
        for a, b in zip(grads[chunk], grads[None]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5)
    assert peaks[1] < peaks[None] and peaks[2] < peaks[None]


@pytest.mark.cuda
def test_the_driver_runs_on_the_nccl_group(nccl_rank):
    from repro_torch.launch import train
    s = train.main(["--steps", "4", "--seq-len", "32", "--block-size", "2",
                    "--collective", "manual", "--stream-chunk", "1",
                    "--log-every", "1"])
    assert s["world_size"] == 1 and s["stream_chunk"] == 1
    assert np.isfinite(s["losses"]).all() and len(s["losses"]) == 4
    assert s["device"] == torch.cuda.get_device_name(nccl_rank)
