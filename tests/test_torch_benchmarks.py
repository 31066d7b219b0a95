"""The port's benchmark suite on the CPU (``--device cpu``), against the
reference where the reference computes the same numbers.

- Each section of ``python -m repro_torch.benchmarks.run --device cpu
  --fast --only <section>`` writes valid JSON that names its device,
  and its inline acceptances hold (``train_step`` in
  ``test_torch_benchmarks_train.py``, with the next pin).
- The serve bench's latency rows equal the reference bench's
  (``simulate_shard_ttft`` over the same seeded rounds) bit for bit.
- The train rows' comm bytes equal the reference's
  ``comm_bytes_per_step`` of the same parameters.
- ``speed_report``'s batched errors equal ``repro.core.monte_carlo_error``
  bit for bit.
- The kernel registry covers every ``pl.pallas_call`` site of
  ``src/repro/kernels``.
- Without ``--device cpu`` every section raises on a host with no card.
"""

import os
import re

import numpy as np
import pytest
import torch

from repro import serve as RS
from repro.configs import CodingConfig as RCoding
from repro.core import expander_assignment as r_expander
from repro.core import monte_carlo_error as r_monte_carlo_error
from repro.dist import coded_train as r_ct
from repro_torch.benchmarks import kernel_bench, run

from torch_bench_common import check_section, sections  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [n for n in run.SECTIONS
                                  if n != "train_step"])
def test_section_writes_valid_json_and_passes(sections, name):
    check_section(sections, name)


def test_latency_rows_equal_the_reference(sections):
    """The reference bench's latency half, at the same seeds and rounds."""
    rep = sections["serve"][1]["results"]["serve"]
    lat_model = RS.ReplicaLatencyModel(m=rep["m_replicas_sim"])
    want = []
    for model, p in (("bernoulli", 0.2), ("markov", 0.2)):
        coding = RCoding(scheme="expander", replication=2,
                         straggler_model=model, straggler_p=p, seed=1)
        rt = r_ct.CodingRuntime(coding, rep["m_replicas_sim"], debias=False)
        W, alive = rt.weights_lookahead(rep["rounds_sim"])
        lat_rng = np.random.default_rng(2)
        lat = np.stack([lat_model.latencies(a, lat_rng) for a in alive])
        coded, uncoded = RS.simulate_shard_ttft(
            rt.assignment, W, alive, lat, deadline_ms=lat_model.deadline_ms,
            straggle_ms=lat_model.straggle_ms)
        want += [RS.percentile_row("expander_d2", model, p, coded),
                 RS.percentile_row("uncoded", model, p, uncoded)]
    assert rep["latency_rows"] == want


def test_speed_report_errors_equal_the_reference(sections):
    rep = sections["decoding"][1]["results"]["decoding"]
    A = r_expander(rep["m"], rep["d"], vertex_transitive=True, seed=0)
    want = r_monte_carlo_error(A, rep["p"], trials=rep["batched"]["trials"],
                               method="optimal", cov=False)
    assert rep["batched"]["mean_error"] == want["mean_error"]
    assert rep["batched"]["std_error"] == want["std_error"]


def test_registry_covers_every_pallas_call_site():
    sites = set()
    kdir = os.path.join(ROOT, "src", "repro", "kernels")
    for dirpath, _, names in os.walk(kdir):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if re.search(r"\bpl\.pallas_call\(", line):
                        sites.add(f"{os.path.relpath(path, ROOT)}:{i}")
    assert len(sites) == 8
    covered = {s.replaces for s in kernel_bench.REGISTRY}
    assert sites <= covered, sites - covered
    entries = {s.entry for s in kernel_bench.REGISTRY}
    assert entries == {"K1", "K2", "K3", "K4", "K5", "K6", "K7a", "K7b",
                       "engine"}


@pytest.mark.parametrize("name", run.SECTIONS)
def test_each_section_needs_a_card_without_device_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run.main(["--only", name, "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_fast_and_full_are_exclusive():
    with pytest.raises(SystemExit):
        run.main(["--fast", "--full", "--device", "cpu"])
    with pytest.raises(SystemExit):
        run.main(["--only", "nope", "--device", "cpu"])
