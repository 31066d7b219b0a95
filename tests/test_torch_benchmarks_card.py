"""The port's benchmark suite and dry-run on the card (marker ``cuda``;
each test skips without one).

Imports no JAX. Run the card tests with ``JAX_PLATFORMS=cpu``: the other
test files import JAX, which would otherwise take most of the card's
memory when a test first touches it.

- Every kernel-bench spec at its path shapes: the kernel within the
  spec's registered tolerance of its plain version, with a device time.
- The dry-run's argument bytes of the train bench's dedup step within 2 %
  of what the allocator holds just before the step's first call.
- ``dryrun_one`` for every arch at ``train_4k`` (meta tensors: nothing
  is allocated on the card) is ``ok`` or ``skipped``.
"""

import gc

import pytest
import torch

from repro_torch.benchmarks import kernel_bench, train_step
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested here)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", kernel_bench.REGISTRY,
                         ids=[s.name for s in kernel_bench.REGISTRY])
def test_kernel_spec_within_tolerance_on_the_card(cuda, spec):
    row = kernel_bench.run_spec(spec, cuda)   # raises beyond tolerance
    torch.cuda.empty_cache()
    if spec.entry == "engine":
        assert row["max_abs_err"] == 0.0 and row["us_per_call"] > 0
        return
    assert row["ms"] > 0 and row["plain_ms"] > 0
    assert 0 < row["bound_ms"] and row["bound_share"] > 0
    assert row["copy_ms"] is None or row["copy_ms"] > 0


@pytest.mark.cuda
def test_dryrun_argument_bytes_match_the_allocator(cuda):
    cfg, size = train_step.bench_config(cuda)
    row = train_step.measure_one(cfg, size, cuda, "expander", "optimal",
                                 steps=3, path="dedup")
    mem = row["memory"]
    assert mem["argument_bytes_measured"] > 0
    assert mem["argument_bytes_rel_diff"] <= 0.02, mem


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_train_4k_every_arch(cuda, arch):
    gc.collect()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    r = dryrun.dryrun_one(arch, "train_4k", multi_pod=False, verbose=False)
    assert r["status"] in ("ok", "skipped")
    assert r["roofline"]["hlo_flops_per_chip"] > 0
    # nothing was allocated on the card at any point of the dry-run
    assert torch.cuda.max_memory_allocated(cuda) == before
