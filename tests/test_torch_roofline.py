"""The port's roofline bookkeeping against the reference's: parameter
counts and model FLOPs for every arch and shape bit for bit, the
three-term report worked out by hand from the H100's constants, and no
TPU constant left in the module."""

import math
import re

import pytest

from repro.configs import ALL_SHAPES as R_SHAPES
from repro.configs import ARCH_IDS, get_config as r_get_config
from repro.launch import roofline as r_rl
from repro_torch.configs import ALL_SHAPES, get_config
from repro_torch.launch import roofline as rl


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_equal_the_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    assert rl.param_count(cfg) == r_rl.param_count(r_cfg)
    assert rl.active_param_count(cfg) == r_rl.active_param_count(r_cfg)
    assert rl._expert_param_count(cfg) == r_rl._expert_param_count(r_cfg)
    for shape, r_shape in zip(ALL_SHAPES, R_SHAPES):
        assert shape.name == r_shape.name
        for d in (1.0, 4.0):
            assert rl.model_flops(cfg, shape, replication=d) == \
                r_rl.model_flops(r_cfg, r_shape, replication=d)


def test_roofline_report_terms_by_hand():
    stats = {"flops": 989e12 * 0.5, "dot_bytes": 3.35e12 * 0.25,
             "collective_bytes": 450e9 * 0.125,
             "collectives": {"none": 450e9 * 0.125}}
    model = {"model_flops": 989e12 * 0.5 * 256 * 0.75}
    r = rl.roofline_report(stats, 256, model, dtype="bfloat16")
    assert r["t_compute_s"] == pytest.approx(0.5, rel=1e-15)
    assert r["t_memory_s"] == pytest.approx(0.25, rel=1e-15)
    assert r["t_collective_s"] == pytest.approx(0.125, rel=1e-15)
    assert r["dominant"] == "compute"
    assert r["hlo_flops_total"] == stats["flops"] * 256
    # the reference's keys, and the card's two more
    ref = r_rl.roofline_report(stats, 256, model)
    assert set(r) == set(ref) | {"peak_flops", "card"}
    assert r["dominant"] == ref["dominant"] == "compute"
    assert r["useful_flops_ratio"] == pytest.approx(0.75, rel=1e-15)
    assert r["collectives"] == stats["collectives"]
    # float32 steps run outside the tensor cores: 67 TFLOP/s
    r32 = rl.roofline_report(dict(stats, flops=67e12), 1, model,
                             dtype="float32")
    assert r32["t_compute_s"] == pytest.approx(1.0, rel=1e-15)
    assert r32["dominant"] == "compute"
    mem = rl.roofline_report(dict(stats, flops=0.0), 1, model)
    assert mem["dominant"] == "memory" and mem["useful_flops_ratio"] == 0.0


def test_constants_are_the_h100s_and_no_tpu_figure_survives():
    assert rl.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert rl.HBM_BW == 3.35e12 and rl.NVLINK_BW == 450e9
    assert rl.HBM_BYTES == 80e9
    assert "H100" in rl.CARD
    numbers = [v for v in vars(rl).values()
               if isinstance(v, (int, float)) and not isinstance(v, bool)]
    numbers += list(rl.PEAK_FLOPS.values())
    for tpu in (197e12, 819e9, 50e9):
        assert all(not math.isclose(v, tpu) for v in numbers)
    with open(rl.__file__) as f:
        src = f.read()
    for text in (r"197e12", r"819e9", r"50e9", r"v5e", r"TPU"):
        assert not re.search(r"(?<![\w.])" + text, src), text
