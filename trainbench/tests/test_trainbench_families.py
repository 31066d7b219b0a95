"""Reference families found by name: a configuration's ``"reference"``
names the module ``trainbench.reference.<name>``, so a new family is new
files only (shown with a toy family registered for the test); ``dense``
and ``hybrid`` make the parameters, losses, gradients and FLOPs they made
before they were found by name (literals pinned from that code); an
unknown family stops ``load_cell``; the program's config takes every
list as a tuple."""

import hashlib
import json
import shutil
import sys
import types

import numpy as np
import pytest

from trainbench import control, harness, inputs, reference
from trainbench.reference import train as ref_train
from trainbench.tests import tiny

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

TOY = '''
"""A one-layer MLP language model: embedding, a residual ReLU MLP, an
untied head."""
import torch.nn.functional as F


def param_shapes(cfg):
    D, V, F_ = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    return {"embed/table": (V, D), "mlp/w_in": (D, F_),
            "mlp/w_out": (F_, D), "head/w": (D, V)}


def init_scale(path, shape):
    return 0.02 if path == "embed/table" else shape[-2] ** -0.5


def init_uniform(path, u):
    return None


def sequence_loss(p, tokens, labels, cfg, q8=lambda x: x):
    x = q8(p["embed/table"][tokens])
    x = x + q8(F.relu(q8(x) @ q8(p["mlp/w_in"]))) @ q8(p["mlp/w_out"])
    return F.cross_entropy(q8(x) @ q8(p["head/w"]), labels,
                           reduction="sum")


def step_flops(cfg, seq_len, sequences):
    D, V, F_ = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    return 6.0 * (2 * D * F_ + D * V) * seq_len * sequences
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "trainbench", root / "trainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _add_cell(root, config: dict):
    """A configuration file, a limits file and entries, the cell on
    ``dedup-seq4k``'s traffic."""
    (root / "trainbench" / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    wl = f"{config['name']}.dedup-seq4k"
    (root / "trainbench" / "limits" / f"{wl}.json").write_text(
        json.dumps(tiny.LIMITS))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": config["name"], "source": "https://example.org/toy",
        "file": f"trainbench/configs/{config['name']}.json", "reduced": [],
        "why": "a toy family"})
    bench["workloads"].append({"name": wl, "config": config["name"],
                               "traffic": "dedup-seq4k", "chips": 1,
                               "why": "a toy family"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return wl


def _load_from(root, name):
    here, top = harness.HERE, harness.ROOT
    try:
        harness.HERE, harness.ROOT = root / "trainbench", root
        return harness.load_cell(name)
    finally:
        harness.HERE, harness.ROOT = here, top


def _ref_steps(cell, seed, steps):
    fam = harness.family_of(cell)
    model, traffic = cell["config"]["model"], cell["traffic"]
    params = inputs.make_params(fam, model, seed, "cpu")
    digest = _digest(params)
    tokens = inputs.tokens_for(cell["config"], traffic, seed)
    n = 2 * traffic["machines"] // traffic["replication"]
    batches = [tokens.batch(n * traffic["block_size"], s)
               for s in range(steps)]
    masks = control.masks_for(traffic, seed, steps)
    out = ref_train.run(fam, model, traffic, seed, params, batches, masks)
    return digest, out


def _digest(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def test_toy_family_needs_only_new_files(tmp_path, monkeypatch):
    """A family module and a configuration naming it: ``load_cell`` finds
    it, the inputs make its parameters, the reference trains it two
    steps, and its FLOPs come from it."""
    mod = types.ModuleType("trainbench.reference.toy")
    exec(compile(TOY, "toy.py", "exec"), mod.__dict__)
    monkeypatch.setitem(sys.modules, "trainbench.reference.toy", mod)
    root = _copy(tmp_path)
    model = {"name": "toy-1L", "d_model": 32, "d_ff": 64, "vocab_size": 300,
             "dtype": "float32"}
    wl = _add_cell(root, {"name": "toy-1L", "source": "toy",
                          "reference": "toy", "model": model,
                          "reduced": []})
    cell = _load_from(root, wl)
    assert harness.family_of(cell) is mod
    cell["traffic"]["seq_len"] = 16
    digest, out = _ref_steps(cell, 2 ** 31 + 7, 2)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert set(out["params"]) == set(mod.param_shapes(model))
    again = inputs.make_params(mod, model, 2 ** 31 + 7, "cpu")
    moved = [float((out["params"][k] - again[k]).norm()) for k in again]
    assert all(m > 0 for m in moved), moved
    assert set(out["first_grad"]) == set(again)
    assert mod.step_flops(model, 16, 4) == 6.0 * (2 * 32 * 64 + 32 * 300) \
        * 64


# The parent's readings at seed 2**31 + 5, sequence length 16, two steps:
# the starting parameters' digest, the two losses, the first gradient's
# norms by leaf (digest of their float.hex) and the trained parameters'
# digest.
PINNED = {
    "granite-3-8b-8L": (
        "5635e89b07c510dd6f197ff9686820b07c40488fbfe649950278aa8ae028fcc2",
        [3.0190662581221197, 3.015383247614396],
        "8b70de8f066f153f37bfc82af28b5fde796d292024e9c12a6c07ca746040a0e5",
        "4542af26f28e430b19ac630fc3ed2102502583cf7baef0dd9e149580c461d776"),
    "hybrid": (
        "b927c40649e3ff780ad730c31edb1438ff20403bc5455fdf06f9531d19020bdb",
        [3.0085013861905923, 3.0133571388203237],
        "cc70bc8b8cce478c41e9ec6103ae92fae62d6321308e1242bda15beb12ae2cdc",
        "24c98c092aa04a542f65d541de3dddf66a7b98def0b457925f9da7b012c38d9e"),
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_families_make_what_they_made(config):
    start, losses, grads, trained = PINNED[config]
    cell = tiny.cell(config, seq_len=16)
    digest, out = _ref_steps(cell, 2 ** 31 + 5, 2)
    assert digest == start
    assert [float(x) for x in out["losses"]] == losses
    got = hashlib.sha256(repr(sorted(
        (k, float(v).hex()) for k, v in out["first_grad"].items()))
        .encode()).hexdigest()
    assert got == grads
    assert _digest(out["params"]) == trained


@pytest.mark.parametrize("config, family, seq_len, sequences, want", [
    ("granite-3-8b-8L", "dense", 4096, 4, 189666963750912.0),
    ("granite-3-8b-8L", "dense", 1024, 16, 179771359100928.0),
    ("hybrid", "hybrid", 64, 4, 262078464.0),
])
def test_step_flops_are_the_parents(config, family, seq_len, sequences,
                                    want):
    """At the cells' shapes (``dedup-seq4k``: 4 sequences of 4,096;
    ``manual-4chip``: 16 of 1,024) and the tiny hybrid's."""
    if config == "hybrid":
        model = tiny.cell("hybrid")["config"]["model"]
    else:
        model = json.loads((ROOT / "trainbench" / "configs" /
                            f"{config}.json").read_text())["model"]
    fam = reference.family(family)
    assert fam.step_flops(model, seq_len, sequences) == want


@pytest.mark.parametrize("name, said", [
    ("no_such_family", "no_such_family"),
    ("coding", "lacks param_shapes"),
    ("../model", "'../model'"),
    (None, "names no reference family"),
])
def test_unknown_family_stops_load_cell(tmp_path, name, said):
    root = _copy(tmp_path)
    config = {"name": "odd-1L", "source": "odd", "model": {}, "reduced": []}
    if name is not None:
        config["reference"] = name
    wl = _add_cell(root, config)
    with pytest.raises(SystemExit, match="odd-1L") as e:
        _load_from(root, wl)
    assert said in str(e.value)


def test_model_config_takes_every_list_as_a_tuple():
    got = harness.model_config({"ModelConfig": lambda **kw: kw}, {
        "name": "x", "attn_positions": [3, 6],
        "hybrid_layer_ids": [[0, 1], [2]], "d_model": 8})
    assert got == {"name": "x", "attn_positions": (3, 6),
                   "hybrid_layer_ids": ((0, 1), (2,)), "d_model": 8}
    P = harness._program()
    cfg = harness.model_config(P, dict(tiny.cell("hybrid")["config"]["model"],
                                       name="h"))
    assert cfg.attn_positions == (1,)
    hash(cfg)
