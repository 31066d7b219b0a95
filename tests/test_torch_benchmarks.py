"""The port's benchmark suite on the CPU (``--device cpu``), against the
reference where the reference computes the same numbers.

- Each section of ``python -m repro_torch.benchmarks.run --device cpu
  --fast --only <section>`` writes valid JSON that names its device,
  and its inline acceptances hold.
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

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro import serve as RS
from repro.configs import CodingConfig as RCoding
from repro.configs import get_config as r_get_config
from repro.core import compress as r_compress
from repro.core import expander_assignment as r_expander
from repro.core import monte_carlo_error as r_monte_carlo_error
from repro.dist import coded_train as r_ct
from repro.models import model as RM
from repro_torch.benchmarks import kernel_bench, roofline_report, run
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"kernels": ["BENCH_torch_kernels.json"],
         "serve": ["BENCH_torch_serve.json"],
         "train_step": ["BENCH_torch_train.json"],
         "decoding": ["BENCH_torch_decoding.json",
                      "BENCH_torch_sweep.json"],
         "roofline": []}


@pytest.fixture(scope="module")
def sections(tmp_path_factory):
    """Each section's CPU run, made on first use and kept for the
    module, on two torch threads (the suite's other workers share the
    host). A section that raised re-raises in its own tests only."""
    return _Sections(tmp_path_factory)


class _Sections:
    def __init__(self, tmp_path_factory):
        self._factory = tmp_path_factory
        self._done = {}

    def __getitem__(self, name):
        if name not in self._done:
            threads = torch.get_num_threads()
            torch.set_num_threads(2)
            try:
                self._done[name] = (True, self._run(name))
            except Exception as exc:      # kept, re-raised per test
                self._done[name] = (False, exc)
            finally:
                torch.set_num_threads(threads)
        ok, value = self._done[name]
        if not ok:
            raise value
        return value

    def _run(self, name):
        d = self._factory.mktemp(name)
        argv = ["--device", "cpu", "--fast", "--only", name, "--out",
                str(d)]
        if name == "roofline":
            dry = d / "dryrun"
            dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k",
                         "--out", str(dry)])
            argv += ["--dryrun-dir", str(dry)]
        return d, run.main(argv)


@pytest.mark.parametrize("name", run.SECTIONS)
def test_section_writes_valid_json_and_passes(sections, name):
    d, res = sections[name]
    assert res["device"] == "cpu"
    assert sorted(os.listdir(d)) == sorted(
        FILES[name] + (["dryrun"] if name == "roofline" else []))
    for fn in FILES[name]:
        with open(d / fn) as f:
            report = json.load(f)
        assert report["device"] == "cpu" and report["mode"] == "fast"
    if name == "kernels":
        rows = res["results"]["kernels"]["rows"]
        assert {r["entry"] for r in rows} >= {"K1", "K2", "K3", "K4", "K5",
                                             "K6", "K7a", "K7b", "engine"}
        # a CPU run gives no card figure
        assert all(r["ms"] is None and r["bound_share"] is None
                   and r["bound_ms"] is None and r["copy_ms"] is None
                   for r in rows)
    if name == "serve":
        acc = res["results"]["serve"]["acceptance"]
        assert acc["token_stream_bit_identical_at_p0"]
        assert acc["coded_p99_lt_uncoded"]
    if name == "train_step":
        rep = res["results"]["train_step"]
        assert len(rep["runs"]) == 9 and rep["chaos"]["m_final"] == 3
        assert "pending" not in rep
        # the streaming-vs-materialising manual pair, m = 8
        pair = [r for r in rep["runs"] if r["m_workers"] == 8]
        assert [(r["collective"], r["stream_chunk"]) for r in pair] == \
            [("manual", 0), ("manual", 1)]
        assert pair[1]["memory"]["temp_bytes"] < \
            pair[0]["memory"]["temp_bytes"]
        assert rep["paired"]["dedup_ms"] < rep["paired"]["replicated_ms"]
        assert [r["compress"] for r in rep["comm"]] == \
            [r["compress"] for r in rep["runs"]]
        # each comm row names its run: the m = 8 pair differs only there
        assert [(r["m_workers"], r["stream_chunk"]) for r in rep["comm"]] \
            == [(r["m_workers"], r["stream_chunk"]) for r in rep["runs"]]
    if name == "decoding":
        sweep = res["results"]["sweep"]
        assert sweep["regime2_grid"]["bit_identical_mean_std"]
        assert sweep["regime2_grid"]["cov_norm_max_rel_diff"] <= 1e-6
        assert res["results"]["decoding"]["m"] == 768   # the CPU's scale
        assert sweep["campaign"]["speedup"] > 0
    if name == "roofline":
        rows = res["results"]["roofline"]
        assert len(rows) == 1 and rows[0]["status"] == "ok"
        assert "| granite-3-8b | decode_32k |" in \
            roofline_report.table(rows)


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


def test_train_comm_bytes_equal_the_reference(sections):
    rep = sections["train_step"][1]["results"]["train_step"]
    params = jax.eval_shape(lambda: RM.init_params(
        r_get_config(rep["arch"]).smoke_variant(), jax.random.PRNGKey(0)))
    for r in rep["runs"]:
        rows = (r["m_workers"] if r["path"] == "replicated"
                else r["global_batch"] // 4)
        codec = (None if r["compress"] == "none"
                 else r_compress.get_codec(r["compress"]))
        assert r["comm_bytes_per_step"] == \
            r_compress.comm_bytes_per_step(codec, rows, params)
        assert r["comm_bytes_per_step_float32"] == \
            r_compress.comm_bytes_per_step(None, rows, params)


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
