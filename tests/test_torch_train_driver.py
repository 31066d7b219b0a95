"""The port's training driver on the CPU (split from
``test_torch_train.py``): it needs the card unless asked for the CPU,
refuses what it does not run, resumes from a checkpoint replaying the
tail, and from one params-only step-0 checkpoint of reference
parameters its loss streams equal the reference driver's within rtol
1e-4 (measured ~2e-5 on the int8 path)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import get_config as rget
from repro_torch.launch import train as ttrain

from torch_train_common import REPO, _env, _ref_params, _two_threads


# ------------------------------------------------------------ driver

def test_driver_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("flag", [
    (["--collective", "manual", "--stream-chunk", "3"], "divisible"),
    (["--stream-chunk", "2"], "--collective manual"),
    (["--chaos", "kill:1@3", "--no-dedup"], "dedup"),
    (["--event-log", "events.json"], "--chaos"),
    (["--production-mesh"], "needs 256 ranks"),
    (["--chaos", "kill:1@3", "--collective", "manual"], "dedup"),
    (["--chaos", "kill:1@3", "--ckpt-dir", "ckpt"], "--chaos"),
    (["--collective", "manual", "--dedup"], "dedup")])
def test_driver_refuses_later_slices_and_bad_combinations(flag, capsys):
    argv, says = flag
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--steps", "1", *argv])
    assert says in capsys.readouterr().err + str(exc.value.code)


def test_driver_resume_replays_the_tail(tmp_path):
    args = ["--device", "cpu", "--steps", "4", "--seq-len", "16",
            "--block-size", "2", "--compress", "int8", "--ckpt-dir"]
    full = ttrain.main(args + [str(tmp_path / "a"), "--ckpt-every", "2"])
    os.remove(tmp_path / "a" / "ckpt_00000004.npz")
    resumed = ttrain.main(args + [str(tmp_path / "a")])
    assert resumed["start_step"] == 2
    assert resumed["losses"] == full["losses"][2:]
    for key in ("first_loss", "last_loss", "losses", "start_step", "steps",
                "m_workers", "scheme", "decoding", "path", "collective",
                "compress", "stream_chunk", "fsdp", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls", "chaos"):
        assert key in full


@pytest.mark.parametrize("extra", [["--compress", "int8"],
                                   ["--collective", "manual"]])
def test_driver_loss_streams_match_reference_driver(tmp_path, extra):
    """Both drivers, same flags, each from its own copy of one
    params-only step-0 checkpoint of reference parameters."""
    rcfg = rget("qwen1.5-4b").smoke_variant()
    tree = _ref_params(rcfg, seed=3)
    for d in ("ref", "port"):
        rckpt.save(str(tmp_path / d), tree, step=0)
    flags = ["--arch", "qwen1.5-4b", "--steps", "6", "--seq-len", "32",
             "--block-size", "2", "--straggler-p", "0.2", *extra]
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *flags,
         "--ckpt-dir", str(tmp_path / "ref")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=420)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", *flags, "--ckpt-dir", str(tmp_path / "port")], cwd=REPO,
        env=dict(_env(), OMP_NUM_THREADS="2"), capture_output=True,
        text=True, timeout=420)
    assert port.returncode == 0, port.stdout + port.stderr
    r = json.loads(ref.stdout.strip().splitlines()[-1])
    p = json.loads(port.stdout.strip().splitlines()[-1])
    assert r["m_workers"] == p["m_workers"] == 4
    for key in ("path", "collective", "compress", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls"):
        assert p[key] == r[key], key
    np.testing.assert_allclose(p["losses"], r["losses"], rtol=1e-4)
