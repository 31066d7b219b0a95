"""The plain reference against the program at small sizes on the CPU:
loss, first gradient, parameter change after three AdamW steps and the
decoder's alpha, through the harness's own run (window and trace
included), on both families and both coded paths."""

import pytest
import torch

from trainbench import harness
from trainbench.tests import tiny

CASES = [("granite-3-8b-8L", "dedup-seq4k"), ("hybrid", "dedup-seq4k"),
         ("granite-3-8b-8L", "manual-4chip")]


@pytest.mark.parametrize("config,traffic", CASES)
def test_program_matches_reference(config, traffic):
    c = tiny.cell(config, traffic,
                  seq_len=24 if traffic == "dedup-seq4k" else 16)
    res = harness.run(c, 2 ** 31 + 77, 0.2, True, torch.device("cpu"),
                      t_start=0.0)
    chk = res["check"]
    assert chk["correct"], chk["numbers"]
    for k, v in chk["numbers"].items():
        assert v["value"] < v["limit"] / 10, (k, v)
    assert res["window_steps"] >= 1 and res["failed"] == 0
    assert res["trace"]["steps"] == c["traffic"].get("traced_steps", 3)
    assert set(res["spans"]) >= {"host_loop", "decode_wait", "step"}
