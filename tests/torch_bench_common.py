"""Helpers shared by ``test_torch_benchmarks.py`` and
``test_torch_benchmarks_train.py``: each section of the port's benchmark
suite run once on the CPU, and the checks of what it writes."""

import json
import os

import pytest
import torch

from repro_torch.benchmarks import roofline_report, run
from repro_torch.launch import dryrun

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


def check_section(sections, name):
    """A section's files, device, mode and inline acceptances."""
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
