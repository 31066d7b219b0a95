"""Compile the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``SOURCES`` becomes one shared library with a plain C
interface, built for ``sm_90a`` into ``_build/`` (git-ignored) at first
use. The library's file name carries a digest of its source and flags,
so an edited source is rebuilt and an unchanged one is reused. Builds of
several sources run as parallel ``nvcc`` processes. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
SOURCES = {
    "rmsnorm": _HERE / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "decode_attention": (_HERE / "decode_attention" / "csrc"
                         / "decode_attention.cu"),
    "coded_combine": _HERE / "coded_combine" / "csrc" / "coded_combine.cu",
    "batched_alpha": _HERE / "batched_alpha" / "csrc" / "batched_alpha.cu",
    "spectral_matvec": (_HERE / "spectral_matvec" / "csrc"
                        / "spectral_matvec.cu"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # name -> nvcc wall time, this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the CUDA "
            "kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.

    Returns {name: seconds} for the sources compiled by this call. The
    compiler's report (``-Xptxas -v``: registers, spills, shared
    memory) lands beside each library as ``<lib>.log``. Raises with the
    compiler's output when any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names
            if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, lib in todo.items():
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        spent = {}
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            spent[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name]} "
                    f"(exit {proc.returncode}):\n{out}")
            lib = todo[name]
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    build_seconds.update(spent)
    return spent


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def compiler_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name``."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line)
