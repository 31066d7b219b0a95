"""The port's training driver under chaos and on the scheme zoo, on the
CPU, against its own clean runs (split from ``test_torch_chaos.py``,
which holds the pins against the reference driver, so that the suite's
workers run the two side by side): a death detected after
``--dead-after`` misses and the code re-drawn over the survivors, the
steps before the first miss equal a clean run's bit for bit (under
``torch.use_deterministic_algorithms``), a transient delay that
re-assigns nothing, the int8 residual following the new row count, and
the zoo's schemes and the adaptive policies training.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.launch import train as ttrain

SMALL = ["--device", "cpu", "--arch", "granite-3-8b", "--seq-len", "16",
         "--block-size", "2", "--log-every", "4"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_kill_reassigns_and_converges(tmp_path, deterministic):
    """The reference's smoke pin in the port: the death is detected
    after --dead-after misses, the code is re-drawn over the 3
    survivors, the steps before the first miss equal a clean run's bit
    for bit, and the run ends near the clean run's loss."""
    log = str(tmp_path / "events.json")
    clean = ttrain.main(SMALL + ["--steps", "12", "--straggler-p", "0"])
    run = ttrain.main(SMALL + ["--steps", "12", "--straggler-p", "0",
                               "--chaos", "kill:1@3", "--event-log", log])
    chaos = run["chaos"]
    assert chaos["dead_machines"] == [1]
    assert chaos["steps_to_detect"] == {"1": 3}
    assert chaos["m_final"] == 3 and chaos["generations"] == 2
    assert chaos["degraded_steps"] == 3
    (re,) = chaos["reassignments"]
    assert re["dead"] == [1] and re["survivors"] == [0, 2, 3]
    assert (re["m"], re["n_blocks"], re["replication"]) == (3, 3, 2)
    assert [e["kind"] for e in chaos["events"]] == \
        ["straggle", "dead", "reassign"]
    assert run["losses"][:3] == clean["losses"][:3]
    assert np.isfinite(run["last_loss"])
    assert abs(run["last_loss"] - clean["last_loss"]) < 0.6
    with open(log) as f:
        assert json.load(f) == chaos


def test_transient_delay_does_not_reassign():
    run = ttrain.main(SMALL + ["--steps", "12", "--straggler-p", "0",
                               "--chaos", "delay:2@4-6:10"])
    chaos = run["chaos"]
    assert chaos["dead_machines"] == [] and chaos["reassignments"] == []
    assert chaos["m_final"] == 4 and chaos["generations"] == 1
    assert "dead" not in {e["kind"] for e in chaos["events"]}
    assert np.isfinite(run["last_loss"])


def test_int8_residual_follows_the_new_row_count():
    """Under --compress the residual restarts at zero over the
    survivors' blocks (4 -> 3 rows) and training goes on."""
    run = ttrain.main(SMALL + ["--steps", "8", "--straggler-p", "0",
                               "--compress", "int8",
                               "--chaos", "kill:0@2"])
    assert run["chaos"]["reassignments"][0]["n_blocks"] == 3
    assert len(run["losses"]) == 8 and np.isfinite(run["losses"]).all()


@pytest.mark.parametrize("extra", [
    ["--scheme", "bibd", "--replication", "3", "--machines", "6",
     "--compress", "sign_packed"],
    ["--scheme", "cyclic_mds", "--straggler-model", "markov",
     "--adaptive", "always_fixed"],
    ["--scheme", "random_regular", "--adaptive", "always_optimal"]])
def test_zoo_and_policies_train(extra):
    run = ttrain.main(SMALL + ["--steps", "8", *extra])
    assert np.isfinite(run["losses"]).all() and len(run["losses"]) == 8
    assert ("adaptive" in run) == ("--adaptive" in extra)
