"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the JAX package, and no source line of the port (or of
``chip_smoke.py``) imports them."""

import json
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|repro)([ .]|$)")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro"))}))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for sub in ("configs", "core", "kernels", "models", "dist", "serve",
                "launch", "data", "optim", "checkpoint"):
        assert f"repro_torch.{sub}" in res["imported"]
    for mod in ("repro_torch.launch.serve", "repro_torch.models.convert",
                "repro_torch.kernels.decode_attention.kernel",
                "repro_torch.kernels.rmsnorm.kernel",
                "repro_torch.launch.train", "repro_torch.data.pipeline",
                "repro_torch.optim.optimizers",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.core.compress",
                "repro_torch.kernels.coded_combine.kernel",
                "repro_torch.kernels.coded_combine.ops",
                "repro_torch.kernels.coded_combine.ref",
                "repro_torch.core.sweep", "repro_torch.core.spectral",
                "repro_torch.core.adaptive", "repro_torch.core.coded_gd",
                "repro_torch.core.theory", "repro_torch.core.debias",
                "repro_torch.kernels.batched_alpha.kernel",
                "repro_torch.kernels.batched_alpha.ops",
                "repro_torch.kernels.spectral_matvec.kernel",
                "repro_torch.kernels.spectral_matvec.ops",
                "repro_torch.launch.harness",
                "repro_torch.dist.failures", "repro_torch.dist.chaos",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.models.xlstm"):
        assert mod in res["imported"]
    assert res["loaded"] == []


def test_no_source_line_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert offenders == []
    assert len(files) > 20


def test_port_layout_mirrors_reference():
    """Each port subpackage has its counterpart in the JAX package, and
    each port module below names a reference module (or is new here)."""
    subs = ("configs", "core", "kernels", "models", "dist", "serve",
            "launch", "data", "optim", "checkpoint")
    for sub in subs:
        assert os.path.isdir(os.path.join(SRC, "repro", sub)), sub
        assert os.path.isfile(os.path.join(PORT, sub, "__init__.py")), sub
    extra = {"models": {"convert"},
             "launch": {"step_profile", "timing", "harness"},
             "kernels": {"build", "_launch"}}
    for sub in ("core", "models", "serve", "dist", "launch", "data",
                "optim", "checkpoint", "kernels"):
        port = {m.name for m in pkgutil.iter_modules(
            [os.path.join(PORT, sub)])} - extra.get(sub, set())
        ref_dir = os.path.join(SRC, "repro", sub)
        ref = {os.path.splitext(n)[0] for n in os.listdir(ref_dir)
               if n.endswith(".py")
               or os.path.isdir(os.path.join(ref_dir, n))}
        assert port <= ref, (sub, port - ref)
