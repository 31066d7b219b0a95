"""The port's training driver on 4 ``gloo`` ranks (spawned with
``torch.multiprocessing`` over a ``FileStore``; each rank calls
``launch.train.main`` in process), on the CPU, at the arguments of
``tests/test_smoke_train.py`` (qwen1.5-4b smoke variant, 12 steps,
sequences of 32 in blocks of 2, p = 0.2).

- ``--collective manual --stream-chunk 1`` against the reference driver
  on its 8-virtual-device (data=4, model=2) mesh, both from one
  params-only checkpoint of reference parameters: m = 4 on both, the
  same path and comm bytes, and the loss streams within rtol 1e-4 (the
  drivers' tolerance of tests/test_torch_train.py).
- ``--dedup --fsdp`` against the port's one-process driver from the same
  checkpoint, within rtol 1e-4; a 4-rank FSDP run resumes the one-process
  run's step-6 checkpoint and its tail equals that run's; the checkpoint
  it writes holds the whole tensors and restores into a one-process run.
- ``--chaos kill:1@3`` on 4 ranks against the port's one-process driver
  (m = 4 -> 3: the 3 blocks stay whole on every rank): the chaos objects
  equal but ``rebuild_s``, the losses within rtol 1e-4.
- Refusals: ``--stream-chunk`` without ``--collective manual`` and
  ``--machines`` not a multiple of W.
- The reference's layout on 4 ranks, (data, model) = (2, 2), with the
  model axis executed (``dist.tensor_parallel``): ``--collective manual
  --stream-chunk 1`` against the same reference driver run (its mesh is
  (4, 2)) within rtol 1e-4; dedup, ``--compress int8`` and ``--fsdp``
  against the one-process driver within 1e-4 (float32 rounding moves
  the streams ~1e-6); each rank's resident parameter bytes equal
  ``bytes_per_device`` under ``safe_param_specs`` (``fsdp_specs`` under
  ``--fsdp``); the FSDP run resumes the one-process step-6 checkpoint,
  and the whole tensors it writes restore into a one-process run;
  ``--chaos kill:1@3 --compress int8`` on (2, 2) against the same
  one-process run; zamba2 (Mamba2's split heads run locally on the
  model group) dedup ``--fsdp`` on (2, 2) against the one-process
  zamba2 run within 1e-4.

The earlier pins mean the data axis alone and run on (4, 1)
(``main(model=1)``).

The reference package is imported inside the tests only, so the spawned
ranks never load JAX.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.launch import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--arch", "qwen1.5-4b", "--steps", "12", "--seq-len", "32",
         "--block-size", "2", "--straggler-p", "0.2"]
WORLD = 4
# zamba2's smoke config on the dedup path, 6 steps: at the CLI's lr
# its training roughly multiplies a rounding difference by 3-10 a step
# from the fourth (rank runs against one process at 8 steps: the data
# axis alone, (4, 1) under --fsdp, 2.2e-4 at the last step; (2, 2)
# 7.4e-4 at the last, 3.9e-5 at the sixth)
ZAMBA2 = ["--arch", "zamba2-1.2b", "--steps", "6", *FLAGS[4:]]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _entry(rank, world, tmp, jobs):
    import traceback
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    out = {}
    try:
        for key, (argv, model) in jobs.items():
            try:
                out[key] = ("ok", ttrain.main(argv, model=model))
            except SystemExit as exc:
                out[key] = ("exit", str(exc.code))
            except BaseException:           # reported by the job's test
                out[key] = ("error", traceback.format_exc())
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 4-rank driver run of the module, in one spawn; and the
    one-process runs they are held to."""
    from repro.checkpoint import checkpoint as rckpt
    from repro.configs import get_config as rget
    import jax
    from repro.models import model as RM
    tmp = tmp_path_factory.mktemp("driver")
    tree = jax.tree.map(np.asarray, RM.init_params(
        rget("qwen1.5-4b").smoke_variant(), jax.random.PRNGKey(3)))
    for d in ("ref", "stream", "fsdp", "single", "single_int8",
              "stream22", "dedup22", "int822", "fsdp22"):
        rckpt.save(str(tmp / d), tree, step=0)
    # the one-process dedup run, with a composite checkpoint at step 6
    single = ttrain.main(["--device", "cpu", *FLAGS, "--ckpt-dir",
                          str(tmp / "single"), "--ckpt-every", "6"])
    single_chaos = ttrain.main(["--device", "cpu", *FLAGS, "--chaos",
                                "kill:1@3"])
    single_chaos_int8 = ttrain.main(["--device", "cpu", *FLAGS, "--chaos",
                                     "kill:1@3", "--compress", "int8"])
    single_int8 = ttrain.main(["--device", "cpu", *FLAGS, "--compress",
                               "int8", "--ckpt-dir",
                               str(tmp / "single_int8")])
    single_zamba2 = ttrain.main(["--device", "cpu", *ZAMBA2])
    shutil.copytree(tmp / "single", tmp / "resume")
    os.remove(tmp / "resume" / "ckpt_00000012.npz")
    shutil.copytree(tmp / "resume", tmp / "resume22")
    cpu = ["--device", "cpu", *FLAGS]
    jobs = {"stream": (cpu + ["--collective", "manual", "--stream-chunk",
                              "1", "--ckpt-dir", str(tmp / "stream")], 1),
            "fsdp": (cpu + ["--fsdp", "--ckpt-dir", str(tmp / "fsdp")], 1),
            "resume": (cpu + ["--fsdp", "--ckpt-dir", str(tmp / "resume")],
                       1),
            "chaos": (cpu + ["--chaos", "kill:1@3"], 1),
            "machines": (cpu + ["--machines", "6"], 1),
            # the reference's layout on 4 ranks: (2, 2)
            "stream22": (cpu + ["--collective", "manual", "--stream-chunk",
                                "1", "--ckpt-dir", str(tmp / "stream22")],
                         None),
            "dedup22": (cpu + ["--ckpt-dir", str(tmp / "dedup22")], None),
            "int822": (cpu + ["--compress", "int8", "--ckpt-dir",
                              str(tmp / "int822")], None),
            "fsdp22": (cpu + ["--fsdp", "--ckpt-dir", str(tmp / "fsdp22")],
                       None),
            "chaos22": (cpu + ["--chaos", "kill:1@3", "--compress", "int8"],
                        None),
            "resume22": (cpu + ["--fsdp", "--ckpt-dir",
                                str(tmp / "resume22")], None),
            "zamba2_fsdp22": (["--device", "cpu", *ZAMBA2, "--fsdp"],
                              None)}
    mp.spawn(_entry, args=(WORLD, str(tmp), jobs), nprocs=WORLD, join=True)
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"tmp": tmp, "single": single, "single_chaos": single_chaos,
            "single_chaos_int8": single_chaos_int8,
            "single_int8": single_int8, "single_zamba2": single_zamba2,
            "ranks": ranks}


def _rank0(runs, key):
    status, value = runs["ranks"][0][key]
    assert status == "ok", value
    for other in runs["ranks"][1:]:
        assert other[key][0] == "ok", other[key][1]
        # every rank sees the summed loss
        assert other[key][1]["losses"] == value["losses"]
    return value


_REFERENCE = {}


def _reference_driver(runs):
    """The reference driver's manual streaming run on its 8 virtual
    devices (mesh (4, 2)), once for the module."""
    if "stream" not in _REFERENCE:
        tmp = runs["tmp"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        ref = subprocess.run(
            [sys.executable, "-m", "repro.launch.train", *FLAGS,
             "--collective", "manual", "--stream-chunk", "1",
             "--ckpt-dir", str(tmp / "ref")], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=420)
        assert ref.returncode == 0, ref.stdout + ref.stderr
        _REFERENCE["stream"] = json.loads(
            ref.stdout.strip().splitlines()[-1])
    return _REFERENCE["stream"]


def test_streaming_manual_on_four_ranks_matches_reference_driver(runs):
    r = _reference_driver(runs)
    p = _rank0(runs, "stream")
    assert r["m_workers"] == p["m_workers"] == 4
    assert p["world_size"] == WORLD and p["stream_chunk"] == 1
    for key in ("path", "collective", "compress", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls"):
        assert p[key] == r[key], key
    np.testing.assert_allclose(p["losses"], r["losses"], rtol=1e-4)
    # one machine a rank: one all_reduce of the float32 gradient a step
    # (and of the loss), one broadcast of w
    assert p["collective_bytes_per_step"]["broadcast"] == 4 * 4
    assert p["collective_bytes_per_step"]["all_reduce"] >= \
        p["comm_bytes_per_step_float32"] / 4


def test_fsdp_on_four_ranks_matches_the_one_process_driver(runs):
    p = _rank0(runs, "fsdp")
    single = runs["single"]
    assert p["fsdp"] and p["world_size"] == WORLD and p["path"] == "dedup"
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)
    # parameters and moments sharded: under a quarter of the whole bytes
    # plus the leaves that do not split
    assert p["resident_bytes"]["params"] < \
        single["resident_bytes"]["params"] / 2
    assert p["collective_bytes_per_step"]["reduce_scatter"] > 0


def test_fsdp_resumes_a_one_process_checkpoint_and_writes_whole_tensors(
        runs):
    p = _rank0(runs, "resume")
    single = runs["single"]
    assert p["start_step"] == 6
    np.testing.assert_allclose(p["losses"], single["losses"][6:],
                               rtol=1e-4)
    tmp = runs["tmp"]
    assert tckpt.saved_steps(str(tmp / "resume")) == [0, 6, 12]
    back = ttrain.main(["--device", "cpu", *FLAGS[:2], "--steps", "14",
                        *FLAGS[4:], "--ckpt-dir", str(tmp / "resume")])
    assert back["start_step"] == 12 and len(back["losses"]) == 2


def _without_rebuild_s(chaos):
    return {**chaos, "reassignments": [
        {k: v for k, v in r.items() if k != "rebuild_s"}
        for r in chaos["reassignments"]]}


def test_chaos_on_four_ranks_matches_the_one_process_driver(runs):
    p, single = _rank0(runs, "chaos"), runs["single_chaos"]
    assert p["world_size"] == WORLD and p["path"] == "dedup"
    assert _without_rebuild_s(p["chaos"]) == \
        _without_rebuild_s(single["chaos"])
    assert p["chaos"]["dead_machines"] == [1]
    assert p["chaos"]["m_final"] == 3
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)


def test_driver_refusals_on_four_ranks(runs, capsys):
    for rank in runs["ranks"]:
        status, code = rank["machines"]
        assert status == "exit" and code == "2"
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--stream-chunk", "1"])
    assert "--collective manual" in capsys.readouterr().err
    # one process is not the production layout's 256 ranks
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--production-mesh"])
    err = capsys.readouterr().err
    assert "--production-mesh" in err and "256" in err and "has 1" in err


# ------------------------------------- the reference's layout: (2, 2)

def _resident_as_placed(p):
    assert p["layout"] == {"data": 2, "model": 2}
    assert p["resident_bytes"]["params"] == \
        p["resident_bytes"]["params_expected"]


def test_model_axis_streaming_on_2x2_matches_reference_driver(runs):
    r = _reference_driver(runs)
    p = _rank0(runs, "stream22")
    _resident_as_placed(p)
    assert r["m_workers"] == p["m_workers"] == 4
    assert p["world_size"] == 2 and p["stream_chunk"] == 1
    for key in ("path", "collective", "compress", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls"):
        assert p[key] == r[key], key
    np.testing.assert_allclose(p["losses"], r["losses"], rtol=1e-4)
    assert p["collective_bytes_per_step"]["model_all_reduce"] > 0


@pytest.mark.parametrize("key,one", [("dedup22", "single"),
                                     ("int822", "single_int8"),
                                     ("fsdp22", "single")])
def test_model_axis_driver_on_2x2_matches_the_one_process_driver(
        runs, key, one):
    p, single = _rank0(runs, key), runs[one]
    _resident_as_placed(p)
    assert p["path"] == single["path"] == "dedup"
    assert p["compress"] == single["compress"]
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)
    # the model axis halves every split leaf: under the whole tree's
    # bytes; FSDP halves it again over the data axis
    assert p["resident_bytes"]["params"] < \
        single["resident_bytes"]["params"] * (0.3 if p["fsdp"] else 0.6)
    others = [rank[key][1] for rank in runs["ranks"]]
    assert all(o["resident_bytes"] == p["resident_bytes"] for o in others)


def test_model_axis_chaos_on_2x2_matches_the_one_process_driver(runs):
    """``--chaos`` on the model axis under ``--compress int8``: one
    decoder a model coordinate, and the residual of model shards rebuilt
    at m = 4 -> 3 (the 3 blocks stay whole on the data ranks)."""
    p, single = _rank0(runs, "chaos22"), runs["single_chaos_int8"]
    _resident_as_placed(p)
    assert _without_rebuild_s(p["chaos"]) == \
        _without_rebuild_s(single["chaos"])
    assert p["chaos"]["m_final"] == 3
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)
    assert p["collective_bytes_per_step"]["model_all_reduce"] > 0


def test_model_axis_checkpoints_cross_layouts(runs):
    """A one-process checkpoint resumes on (2, 2) under FSDP, and the
    whole tensors (2, 2) writes restore into one process."""
    p = _rank0(runs, "resume22")
    assert p["start_step"] == 6
    np.testing.assert_allclose(p["losses"], runs["single"]["losses"][6:],
                               rtol=1e-4)
    tmp = runs["tmp"]
    assert tckpt.saved_steps(str(tmp / "fsdp22")) == [0, 12]
    back = ttrain.main(["--device", "cpu", *FLAGS[:2], "--steps", "14",
                        *FLAGS[4:], "--ckpt-dir", str(tmp / "fsdp22")])
    assert back["start_step"] == 12 and len(back["losses"]) == 2


def test_model_axis_zamba2_fsdp_on_2x2_matches_one_process(runs):
    """Mamba2's heads split over the model group (4 of 8 a rank) and the
    shards over the data group under ``--fsdp``."""
    p, single = _rank0(runs, "zamba2_fsdp22"), runs["single_zamba2"]
    _resident_as_placed(p)
    assert p["fsdp"] and p["path"] == single["path"] == "dedup"
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)
    assert p["collective_bytes_per_step"]["model_all_to_all"] > 0
    assert p["resident_bytes"]["params"] < \
        single["resident_bytes"]["params"] * 0.3
