"""PyTorch port of the coded-computation system in ``repro``.

The package mirrors ``repro``'s layout (configs, core, kernels, models,
dist, serve, launch). It imports ``torch`` and NumPy only: never JAX,
and nothing of ``repro``. Host-side NumPy code (graphs, assignments,
straggler processes, decoders) is carried as its own copy so that the
RNG protocol, masks and decode weights stay bit-identical to the
reference. Hot device work runs through hand-written CUDA kernels for
Hopper (``kernels/``).
"""
