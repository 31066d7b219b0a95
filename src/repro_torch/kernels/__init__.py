"""Hand-written CUDA kernels for Hopper (sm_90a), one package each.

Every package keeps the reference's ``kernel`` / ``ops`` / ``ref``
split: ``csrc/*.cu`` is the kernel, ``kernel.py`` binds it with
``ctypes``, ``ref.py`` is the plain PyTorch version and ``ops.py``
dispatches -- the kernel for a CUDA tensor, the plain version only for
a CPU tensor. ``build.py`` compiles the sources with ``nvcc`` at first
use into the git-ignored ``_build/`` directory.
"""
