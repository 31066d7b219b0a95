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
                "launch"):
        assert f"repro_torch.{sub}" in res["imported"]
    for mod in ("repro_torch.launch.serve", "repro_torch.models.convert",
                "repro_torch.kernels.decode_attention.kernel",
                "repro_torch.kernels.rmsnorm.kernel"):
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
            "launch")
    for sub in subs:
        assert os.path.isdir(os.path.join(SRC, "repro", sub)), sub
        assert os.path.isfile(os.path.join(PORT, sub, "__init__.py")), sub
    extra = {"models": {"convert"}, "launch": {"step_profile", "timing"}}
    for sub in ("core", "models", "serve", "dist", "launch"):
        port = {m.name for m in pkgutil.iter_modules(
            [os.path.join(PORT, sub)])} - extra.get(sub, set())
        ref = {os.path.splitext(n)[0] for n in os.listdir(
            os.path.join(SRC, "repro", sub)) if n.endswith(".py")}
        assert port <= ref, (sub, port - ref)
