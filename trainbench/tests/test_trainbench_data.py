"""The benchmark's data: every cell finds its configuration, traffic and
limits by name, the files name only keys the harness knows, every
per-layer metric has its reader, and a new cell or metric needs only new
files and entries (shown with a throwaway traffic file and reader)."""

import json
import shutil

import pytest
import torch

from trainbench import harness, inputs, reference

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAFFIC_KEYS = {"path", "scheme", "replication", "machines",
                "straggler_model", "straggler_p", "seq_len", "block_size",
                "lookahead", "optimizer", "tokens", "checked_steps",
                "stream_chunk", "model_axis", "traced_steps"}
CONFIG_KEYS = {"name", "source", "reference", "published", "as_run",
               "model", "reduced", "assumed", "departures", "deployment"}
MODEL_KEYS = {"name", "arch_type", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "rope_theta", "dtype",
              "param_dtype", "norm_eps", "tie_embeddings", "ssm_state",
              "ssm_expand", "ssm_conv", "attn_positions"}


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(wl):
    cell = harness.load_cell(wl)
    assert set(cell["traffic"]) <= TRAFFIC_KEYS
    assert set(cell["config"]) <= CONFIG_KEYS
    assert set(cell["config"]["model"]) <= MODEL_KEYS
    compared = set(cell["limits"]) - {"why"}
    assert "alpha_gap" in compared and len(compared) >= 3
    assert compared <= set(harness.NUMBERS)
    conf = next(c for c in BENCH["configs"]
                if c["name"] == cell["workload"]["config"])
    assert conf["file"] == f"trainbench/configs/{conf['name']}.json"
    assert conf["reduced"] == cell["config"]["reduced"]
    assert conf["source"] == cell["config"]["source"]
    changed = {k for k, v in cell["config"]["published"].items()
               if cell["config"]["as_run"].get(k) != v}
    assert set(conf["reduced"]) <= changed
    departed = " ".join(cell["config"].get("departures", []))
    assert all(k in departed for k in changed - set(conf["reduced"]))
    P = harness._program()
    harness.model_config(P, cell["config"]["model"])
    assert harness.family_of(cell).param_shapes(cell["config"]["model"])


def test_reference_layout_is_the_programs():
    """The reference's parameter layout, in which the benchmark makes the
    weights, is the program's."""
    P = harness._program()
    from repro_torch.models.convert import param_shapes
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        model = cfg["model"]
        fam = reference.family(cfg["reference"])
        mine = {k: tuple(v) for k, v in fam.param_shapes(model).items()}
        theirs = {k: tuple(v) for k, v in param_shapes(
            harness.model_config(P, model)).items()}
        assert mine == theirs


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert (ROOT / "trainbench" / "metrics" / f"{m['name']}.py").exists()


def test_mamba2_initialisation():
    """A_log and dt_bias are drawn as Mamba2 draws them, from the seed:
    A in [1, 16], softplus(dt_bias) in [1e-3, 0.1]; D and norm scales
    are 1."""
    hybrid = reference.family("hybrid")
    a = inputs.make_leaf(hybrid, "blocks/ssm/A_log", (3, 64), 2 ** 33 + 1,
                         "cpu")
    dt = inputs.make_leaf(hybrid, "blocks/ssm/dt_bias", (3, 64),
                          2 ** 33 + 1, "cpu")
    A, step = a.exp(), torch.nn.functional.softplus(dt)
    assert 1.0 <= A.min() and A.max() <= 16.0 and A.std() > 2.0
    assert 0.999e-3 <= step.min() and step.max() <= 0.1001
    assert step.log().std() > 0.5
    again = inputs.make_leaf(hybrid, "blocks/ssm/A_log", (3, 64),
                             2 ** 33 + 1, "cpu")
    assert torch.equal(a, again)
    for path in ("blocks/ssm/D", "blocks/ln/scale"):
        assert torch.equal(inputs.make_leaf(hybrid, path, (3, 64), 5, "cpu"),
                           torch.ones(3, 64))


def test_tokens_same_sizes_any_seed():
    a = inputs.Tokens(1000, 33, 2 ** 33 + 5).batch(8, 3)
    b = inputs.Tokens(1000, 33, 1).batch(8, 3)
    assert a["tokens"].shape == b["tokens"].shape == (8, 33)
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()
    assert a["tokens"].max() < 1000
    again = inputs.Tokens(1000, 33, 2 ** 33 + 5).batch(8, 3)
    assert (again["tokens"] == a["tokens"]).all()


def test_new_cell_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add a traffic file, a limits file, a reader and
    their entries, and the harness finds them without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "trainbench", root / "trainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    wl = bench["workloads"][0]
    tr = json.loads((ROOT / "trainbench" / "traffic" /
                     f"{wl['traffic']}.json").read_text())
    tr["seq_len"] = 512
    (root / "trainbench" / "traffic" / "throwaway.json").write_text(
        json.dumps(tr))
    name = f"{wl['config']}.throwaway"
    (root / "trainbench" / "limits" / f"{name}.json").write_text(
        (ROOT / "trainbench" / "limits" / f"{wl['name']}.json").read_text())
    (root / "trainbench" / "metrics" / "throwaway_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    bench["workloads"].append(dict(wl, name=name, traffic="throwaway"))
    bench["per_layer"].append({"name": "throwaway_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "train loop",
                               "moves": "train_tokens_per_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import importlib.util
    # load_cell of the copy: the same code, pointed at the copy's files
    cell = _load_from(root, name)
    assert cell["traffic"]["seq_len"] == 512
    assert any(m["name"] == "throwaway_ms" for m in cell["per_layer"])
    tokens = inputs.tokens_for(cell["config"], cell["traffic"], 3)
    assert tokens.batch(4, 0)["tokens"].shape == (4, 512)
    from trainbench import run
    spec = importlib.util.spec_from_file_location(
        "throwaway", root / "trainbench" / "metrics" / "throwaway_ms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({}) == 1.5
    assert run._reader("host_loop_ms")


def _load_from(root, name):
    import trainbench.harness as h
    here, top = h.HERE, h.ROOT
    try:
        h.HERE, h.ROOT = root / "trainbench", root
        return h.load_cell(name)
    finally:
        h.HERE, h.ROOT = here, top
