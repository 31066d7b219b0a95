"""The command's refusals: with no card it exits non-zero and prints no
result (no CPU number under a device metric); JAX and the JAX package
are caught by whole top-level names; neither the harness nor the
reference loads them, and the reference loads nothing of the program."""

import os
import subprocess
import sys

import pytest

from trainbench import harness, run

ROOT = harness.ROOT


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    env.update(kw)
    return env


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "trainbench.run", "--workload",
         "granite-3-8b-8L.dedup-seq4k", "--seed", str(2 ** 31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=str(ROOT), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_bare_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder
    has no program to run: the command exits non-zero with no result."""
    import shutil
    shutil.copytree(ROOT / "trainbench", tmp_path / "trainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(
        [sys.executable, "-m", "trainbench.run", "--workload",
         "granite-3-8b-8L.dedup-seq4k", "--seed", "1", "--seconds", "1",
         "--trace", "1"],
        cwd=str(tmp_path), env=_env(PYTHONPATH=""), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.dist",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "repro_torch"]) == ["repro"]
    assert run.forbidden_modules(["jaxlib.xla_client", "flax.linen",
                                  "jax"]) == ["flax", "jax", "jaxlib"]


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_imports(what):
    """The harness with the program loaded holds no JAX; the reference
    holds neither JAX nor the program."""
    code = ("import sys\n"
            "import trainbench.run as r, trainbench.control, "
            "trainbench.reference.train\n"
            + ("import trainbench.harness as h; h._program()\n"
               if what == "harness" else "")
            + "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro', "
            "'repro_torch'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    want = "['repro_torch']" if what == "harness" else "[]"
    assert p.stdout.strip() == want
