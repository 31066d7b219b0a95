"""The card-side parts of the elastic and runtime slice.

Kept apart from the CPU pins because those import the JAX package,
which the card's machine does not have; every test here needs an NVIDIA
GPU (marker ``cuda``) and skips without one:

- fault C1's card side: ``CodingRuntime(device="cpu")`` keeps its debias
  decode on the host, ``device="cuda"`` runs it through the torch label
  propagator, and both scales are equal bit for bit (as are the labels);
- ``quantized_combine`` (K4) at the elastic run's 3 rows against its
  plain version, bit for bit on exact inputs;
- the chaos smoke under int8 at smoke size through the kernels: one K4
  launch per leaf and step across both generations, and the plain
  versions' loss stream within 1e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import CodingConfig as TCoding, get_config
from repro_torch.core import step_weights as tsw
from repro_torch.core.assignment import expander_assignment as t_expander
from repro_torch.dist import coded_train as TT
from repro_torch.models import model as M

CPU = "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and the card's "
                    "label propagator have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runtime_device_cpu_keeps_the_decode_on_the_host(cuda):
    from repro_torch.core import batched_decoding as bd
    cfg = TCoding(scheme="expander", replication=2, straggler_p=0.2)
    calls = []
    orig = bd._propagate_torch

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    bd._propagate_torch = spy
    try:
        host = TT.CodingRuntime(cfg, 1000, device=CPU).scale
        assert calls == []
        card = TT.CodingRuntime(cfg, 1000, device=cuda).scale
        assert len(calls) >= 1
    finally:
        bd._propagate_torch = orig
    assert card == host
    A = t_expander(1000, 2, vertex_transitive=True, seed=0)
    alive = tsw.bernoulli_uniforms(A.m, 256, 0x5EED) >= 0.2
    np.testing.assert_array_equal(
        bd._propagate_torch(A.graph, alive, None, cuda),
        bd._propagate_numpy(A.graph, alive))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8192, 1_000_003, 104_857_600])
def test_quantized_combine_at_three_rows_equals_plain_on_card(cuda, D):
    """K4 at the elastic run's row count after the re-assignment."""
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.kernels.coded_combine import ref as cc_r
    g = torch.Generator(device=cuda).manual_seed(D % 997)
    q = torch.randint(-127, 128, (3, D), generator=g, device=cuda,
                      dtype=torch.int8)
    s = 2.0 ** torch.randint(-4, 2, (3,), generator=g, device=cuda).float()
    w = 2.0 ** torch.randint(-3, 3, (3,), generator=g, device=cuda).float()
    before = cc_ops.launches["quantized_combine"]
    out = cc_ops.quantized_combine(q, s, w)
    torch.cuda.synchronize()
    assert cc_ops.launches["quantized_combine"] == before + 1
    assert torch.equal(out, cc_r.quantized_combine(q, s, w))


@pytest.mark.cuda
def test_elastic_int8_run_on_card_through_the_kernels(cuda):
    """The chaos smoke under int8 at smoke size on the card: one K4
    launch per leaf and step across both generations (4 blocks, then
    3), and the loss stream of the plain versions within 1e-2."""
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.launch import train as ttrain
    argv = ["--device", "cuda", "--arch", "granite-3-8b", "--steps", "8",
            "--seq-len", "16", "--block-size", "2", "--straggler-p", "0",
            "--compress", "int8", "--chaos", "kill:1@3"]
    cc_ops.launches["quantized_combine"] = 0
    run = ttrain.main(argv)
    n_leaves = len(T.leaves(M.init_params(
        get_config("granite-3-8b").smoke_variant(), device=CPU)))
    assert cc_ops.launches["quantized_combine"] == n_leaves * 8
    assert run["chaos"]["m_final"] == 3
    cc_ops._FORCE = "ref"
    try:
        plain = ttrain.main(argv)
    finally:
        cc_ops._FORCE = None
    np.testing.assert_allclose(run["losses"], plain["losses"], rtol=1e-2)
