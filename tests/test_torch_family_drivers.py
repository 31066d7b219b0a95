"""The training drivers on two more families: from one params-only
step-0 checkpoint of reference parameters, ``repro.launch.train`` and
``repro_torch.launch.train --device cpu`` with the same flags give loss
streams within rtol 1e-4 (as tests/test_torch_train.py holds the dense
family), and the same comm bytes and decode calls.

deepseek-moe-16b (expert-choice MoE, shared experts) and zamba2-1.2b
(Mamba2 blocks around a shared attention block) on the dedup path,
float32 smoke variants, 6 steps. The port's driver
runs in this process under ``torch.use_deterministic_algorithms``, so
that its stream is the same on every run.

Expert-choice routing is discontinuous: an expert takes a token or does
not. Where two tokens' router probabilities are a float32 rounding
apart, the two libraries' reduction orders may pick differently, and
the loss moves by far more than 1e-4 from that step on. So the port's
driver records, for every routing call, the relative gap between each
expert's C-th and (C+1)-th probability. The streams must agree within
1e-4 at every step until they part, they may part only at or after a
step with a gap in (0, ``NEAR_TIE``), and they must agree over at least
half the steps; the test shows the near-ties. (A gap of 0 is an exact
tie, which both packages break toward the lower index:
tests/test_torch_mixers.py. A near-tie need not part the streams: at
deepseek-moe-16b's step 2 two tokens whose router inputs are equal in
exact arithmetic -- a repeated token, its attention output the mean of
two equal values -- land an ulp apart, and the streams agree on.)
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
NEAR_TIE = 1e-6       # relative top-C gap within float32 reduction noise


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


def _reference_driver(flags):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.train",
                           *flags], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=420)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _recording_gaps(monkeypatch):
    """Wrap the port's top-C so that each routing call appends its
    smallest relative gap between the C-th and (C+1)-th value."""
    gaps = []
    top = tmoe.top_k_stable

    def recorded(x, k):
        if k < x.shape[-1]:
            v = torch.sort(x.detach(), dim=-1, descending=True).values
            gaps.append(float(((v[..., k - 1] - v[..., k])
                               / v[..., k - 1]).min()))
        return top(x, k)
    monkeypatch.setattr(tmoe, "top_k_stable", recorded)
    return gaps


@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", []),
    ("zamba2-1.2b", [])])
def test_driver_loss_streams_match_reference_driver(
        tmp_path, monkeypatch, deterministic, arch, extra):
    tree = jax.tree.map(np.asarray, RM.init_params(
        rget(arch).smoke_variant(), jax.random.PRNGKey(3)))
    for d in ("ref", "port"):
        rckpt.save(str(tmp_path / d), tree, step=0)
    flags = ["--arch", arch, "--steps", str(STEPS), "--seq-len", "32",
             "--block-size", "2", "--straggler-p", "0.2", *extra]
    r = _reference_driver(flags + ["--ckpt-dir", str(tmp_path / "ref")])
    gaps = _recording_gaps(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        p = ttrain.main(["--device", "cpu", *flags, "--ckpt-dir",
                         str(tmp_path / "port")])
    assert r["m_workers"] == p["m_workers"] == 4
    for key in ("path", "collective", "compress", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls"):
        assert p[key] == r[key], key
    near = []
    if gaps:
        per_step = len(gaps) // STEPS
        assert per_step * STEPS == len(gaps)
        near = sorted({i // per_step for i, g in enumerate(gaps)
                       if 0 < g < NEAR_TIE})
    rel = np.abs(np.subtract(p["losses"], r["losses"])) / np.abs(
        r["losses"])
    parted = next((i for i in range(STEPS) if rel[i] > 1e-4), STEPS)
    assert parted == STEPS or (near and near[0] <= parted), \
        f"the streams part at step {parted} before any routing near-tie"
    assert parted >= STEPS // 2, \
        f"the streams part at step {parted} (routing near-ties at {near})"
    np.testing.assert_allclose(p["losses"][:parted], r["losses"][:parted],
                               rtol=1e-4)
