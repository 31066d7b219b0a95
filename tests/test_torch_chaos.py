"""The port's training driver under chaos, the scheme zoo and adaptive
decoding, on the CPU.

Driver parity: the reference driver runs as a subprocess (on its 8
virtual devices, so its worker count is 4) and the port's in this
process with ``--machines 4``. Both start from the same reference
parameters: the reference initialises from ``PRNGKey(seed)``, and the
port's ``init_params`` is replaced by the NumPy crossing of that same
tree (``--chaos`` refuses ``--ckpt-dir`` in both drivers, so the
params-only checkpoint route of ``tests/test_torch_train.py`` is shut).
The ``chaos`` and ``adaptive`` summary objects are host NumPy and must
be equal (``rebuild_s`` is a wall time and is left out); loss streams
agree within rtol 1e-4, the tolerance of the other driver pins. The
port's runs against its own clean runs are in
``test_torch_chaos_port.py``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI_CHAOS = ["--arch", "granite-3-8b", "--steps", "10", "--seq-len", "32",
            "--block-size", "2", "--straggler-p", "0", "--scheme",
            "expander", "--decoding", "optimal", "--replication", "2",
            "--dedup", "--seed", "0", "--log-every", "2"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _reference_driver(flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    proc = subprocess.run([sys.executable, "-m", "repro.launch.train",
                           *flags], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_driver(monkeypatch, flags, arch="granite-3-8b", seed=0):
    """The port's driver from the reference's own initial parameters."""
    rcfg = rget(arch).smoke_variant()
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(
        ttrain.M, "init_params",
        lambda cfg, seed, device: params_from_numpy(tree, cfg,
                                                    device=device))
    return ttrain.main(["--device", "cpu", *flags])


def _without_rebuild_s(chaos):
    out = json.loads(json.dumps(chaos))
    for r in out["reassignments"]:
        assert r.pop("rebuild_s") is not None
    return out


def test_ci_chaos_smoke_equals_reference_driver(monkeypatch, tmp_path):
    """CI's seeded chaos smoke (kill machine 1 at step 3) through both
    drivers: CI's five conditions on the port's event log, the log equal
    to the summary, the chaos objects equal, the losses within 1e-4."""
    log = str(tmp_path / "events.json")
    ref = _reference_driver(CI_CHAOS + ["--chaos", "kill:1@3"])
    port = _port_driver(monkeypatch, CI_CHAOS + [
        "--chaos", "kill:1@3", "--event-log", log])
    with open(log) as f:
        logged = json.load(f)
    assert logged == port["chaos"]
    assert logged["dead_machines"] == [1]
    assert logged["steps_to_detect"] == {"1": 3}
    assert len(logged["reassignments"]) == 1
    assert logged["m_final"] == 3 and logged["generations"] == 2
    assert _without_rebuild_s(port["chaos"]) == \
        _without_rebuild_s(ref["chaos"])
    assert ref["m_workers"] == port["m_workers"] == 4
    for key in ("path", "decode_calls", "comm_bytes_per_step"):
        assert port[key] == ref[key], key
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)


def test_adaptive_markov_equals_reference_driver(monkeypatch):
    flags = ["--arch", "granite-3-8b", "--steps", "8", "--seq-len", "32",
             "--block-size", "2", "--straggler-p", "0.2",
             "--straggler-model", "markov", "--adaptive", "adaptive",
             "--seed", "0", "--log-every", "2"]
    ref = _reference_driver(flags)
    port = _port_driver(monkeypatch, flags)
    assert port["adaptive"] == ref["adaptive"]
    assert sum(port["adaptive"]["decision_counts"].values()) == 8
    assert port["decode_calls"] == ref["decode_calls"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)


def test_machines_1000_runs_on_the_host():
    """Fault C1 at the driver: m = 1000 machines on the CPU (the debias
    batch reaches the propagator's work threshold)."""
    run = ttrain.main(["--device", "cpu", "--machines", "1000", "--steps",
                       "2", "--seq-len", "8", "--block-size", "1"])
    assert run["m_workers"] == 1000 and len(run["losses"]) == 2


@pytest.mark.parametrize("flags,needle", [
    (["--chaos", "kill:1@3", "--ckpt-dir", "x"], "--ckpt-dir"),
    (["--event-log", "x.json"], "--chaos"),
    (["--chaos", "kill:1@3", "--no-dedup"], "dedup"),
    (["--chaos", "kill:1@3", "--collective", "manual"], "dedup"),
    (["--collective", "manual", "--stream-chunk", "3"], "divisible"),
    (["--stream-chunk", "2"], "--collective manual"),
    (["--production-mesh"], "needs 256 ranks")])
def test_driver_refuses_as_the_reference(flags, needle, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--steps", "1", *flags])
    assert needle in capsys.readouterr().err + str(exc.value.code)
