"""The serve CLI on the model families, on the CPU (split from
``test_torch_family_serving.py`` so that the suite's workers run the two
side by side): moe, hybrid and ssm through the engine with ``--device
cpu --check`` (engine streams equal to the sequential reference loop,
bit for bit), vlm and audio through the static-batch path's summary.
"""

import contextlib
import io
import json

import pytest
import torch

from repro_torch.launch import serve as tserve

ENGINE = ("deepseek-moe-16b", "zamba2-1.2b", "xlstm-1.3b")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cli(*args):
    """The serve CLI's ``main`` in this process (tests/test_torch_serve.py
    runs the module as a subprocess); returns its printed summary."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--device", "cpu", *args])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ENGINE)
def test_serve_cli_checks_engine_families_on_cpu(arch):
    s = _cli("--arch", arch, "--requests", "6", "--max-new-tokens", "4",
             "--check")
    assert s["path"] == "engine" and s["arch"] == arch
    assert s["check_passed"] is True and s["device"] == "cpu"
    assert s["new_tokens"] == 24 and s["pool_steps"] > s["iterations"] > 0


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-large-v2"])
def test_serve_cli_static_path_on_cpu(arch):
    s = _cli("--arch", arch, "--slots", "3", "--max-new-tokens", "4")
    assert s["path"] == "static" and s["arch"] == arch
    assert s["requests"] == 3 and s["new_tokens"] == 12
    assert s["device"] == "cpu" and len(s["sample"]) == 4
