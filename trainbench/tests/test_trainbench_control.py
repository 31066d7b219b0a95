"""The control at a size a test run holds: the reference put in the
program's place and computed in fp8 (the precision below the
configurations' bfloat16), and the planted faults (AdamW's decay left out
among them), each fail a number that the float32 program passes at the
same size."""

import pytest
import torch

from trainbench import control
from trainbench.tests import tiny


@pytest.mark.parametrize("config", ["granite-3-8b-8L", "hybrid"])
def test_control_and_faults_fail(config):
    c = tiny.cell(config, seq_len=16)
    got = control.readings(c, 2 ** 31 + 3, torch.device("cpu"),
                           ["fp8", "half_batch", "alpha", "no_decay"])
    for r in got:
        over = [k for k, v in r["numbers"].items() if v["value"] > v["limit"]]
        assert over, (r["mode"], r["numbers"])


def test_rank_only_fault_fails():
    c = tiny.cell("granite-3-8b-8L", "manual-4chip", seq_len=16, chips=4)
    got = control.readings(c, 11, torch.device("cpu"), ["rank_only"], cards=4)
    over = [k for k, v in got[0]["numbers"].items()
            if v["value"] > v["limit"]]
    assert over, got[0]["numbers"]
