"""The training benchmark of the PyTorch port (``repro_torch``).

``python3 -m trainbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last. Cells, configurations, traffic mixes, per-layer metrics
and limits are data under this folder, found by name.
"""
