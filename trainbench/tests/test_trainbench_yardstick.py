"""The yardstick: the FLOP counter against the program's own count of a
step's matmuls (``launch/step_analysis.py``), the trace reduction, and
the metric readers on what they can and cannot read."""

import json

import pytest
import torch

from trainbench import harness, trace
from trainbench.reference import model as ref_model
from trainbench.tests import tiny


def _program_count(c):
    """FLOPs the program's step dispatches on meta tensors, without remat
    (``step_analysis.analyze`` of one dedup loss and its gradient)."""
    P = harness._program()
    from repro_torch.launch import step_analysis
    from repro_torch.models import model as M
    model = c["config"]["model"]
    cfg = harness.model_config(P, model)
    S, rows = c["traffic"]["seq_len"], 4
    params = {k: torch.empty(s, device="meta") for k, s in
              harness.family_of(c).param_shapes(model).items()}
    from trainbench import inputs
    params = inputs.nest(params)
    batch = {"tokens": torch.zeros(rows, 1, S, dtype=torch.long,
                                   device="meta"),
             "labels": torch.zeros(rows, 1, S, dtype=torch.long,
                                   device="meta")}
    v = torch.ones(rows, device="meta")
    cc = P["coded_train"]
    old = M._REMAT
    M._REMAT = False
    try:
        stats = step_analysis.analyze(lambda: cc.value_and_grad(
            lambda p: cc.coded_loss_fn_dedup(p, batch, v, cfg), params))
    finally:
        M._REMAT = old
    return stats["flops"], rows


@pytest.mark.parametrize("config", ["granite-3-8b-8L", "hybrid"])
def test_flops_against_the_programs_count(config):
    """The program counts every matmul it dispatches: the padded
    vocabulary, the masked half of each attention tile (and the flash
    backward's second Q K^T), the masked half of each SSD chunk, and the
    SSD einsums' own factorisation. Its matmul-parameter term is the
    counter's with the padded vocabulary, and what it counts beyond that
    lies between once and three times the counter's attention and scan
    terms."""
    c = tiny.cell(config, seq_len=64)
    model = c["config"]["model"]
    fam = harness.family_of(c)
    got, rows = _program_count(c)
    S = c["traffic"]["seq_len"]
    mine = fam.step_flops(model, S, rows)
    mm = 6.0 * fam.matmul_params(model) * S * rows
    pad = 6.0 * model["d_model"] * (ref_model.padded_vocab(
        model["vocab_size"]) - model["vocab_size"]) * S * rows
    extra_prog = got - mm - pad
    extra_mine = mine - mm
    assert extra_prog > 0 and extra_mine > 0
    assert extra_mine <= extra_prog <= 3.0 * extra_mine, (got, mine)


def test_trace_reduction(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "rmsnorm_kernel<bf16>",
           "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "tb:host_loop",
           "ts": 10, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 100}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    red = trace.reduce(str(p))
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["kernels"]["gemm"]["launches"] == 2
    assert red["idle_gaps"] == [["host_loop", pytest.approx(25e-6)]]
    assert trace.matching(red["kernels"], "rmsnorm")["launches"] == 1
    assert trace.top_ops(red["kernels"])[0][0] == "gemm"


def _ctx(kernels, traffic="dedup-seq4k", cards=1):
    c = tiny.cell("granite-3-8b-8L", traffic)
    rank = {"window_steps": 4, "window_s": 2.0,
            "spans": {"host_loop": [0.001] * 4, "decode_wait": [0.002] * 4},
            "trace": {"busy_s": 0.5, "window_s": 1.0, "steps": 2,
                      "kernels": kernels},
            "traffic_bytes_per_step": {"all_reduce": 2 ** 30}}
    return {"ranks": [rank] * cards, "cell": c, "model": c["config"]["model"],
            "traffic": c["traffic"], "tokens_per_step": 1, "cards": cards}


def test_readers_read_what_is_there_and_nothing_else():
    from trainbench.run import _reader
    names = [m["name"] for m in json.loads(
        (tiny.HERE.parent / "BENCHMARK.json").read_text())["per_layer"]]
    empty = _ctx({})
    for name in names:
        v = _reader(name)(empty)
        assert v is None or v > 0, (name, v)
    assert _reader("k1_rmsnorm_roofline")(empty) is None
    assert _reader("device_idle_share")(empty) == pytest.approx(50.0)
    k1 = _ctx({"rmsnorm_kernel<bf16, 4>": {"seconds": 1e-3,
                                           "launches": 10}})
    share = _reader("k1_rmsnorm_roofline")(k1)
    assert 0 < share < 100
