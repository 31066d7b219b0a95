"""Serving over a worker group: two ``gloo`` ranks on the CPU, spawned
once for the module with ``torch.multiprocessing`` over a ``FileStore``
in the test's directory, each calling ``launch.serve.main`` in process.

- The engine on the reference's default layout for two ranks, (data,
  model) = (1, 2), with the model axis executed (granite: every leaf
  ``safe_param_specs`` splits, heads 2 and 2 a rank; deepseek-moe: the
  expert stacks; zamba2: the rank's 4 of 8 Mamba2 heads, the bcdt
  features all-gathered, and the shared attention's 2 of 4 heads; xlstm
  at 4 layers, one mLSTM and one sLSTM a super-block: the rank's 2 of 4
  mLSTM heads and 128 of 256 sLSTM units), and
  on (2, 1), the slot axis split over the data ranks (2 slots a rank,
  the new tokens all-gathered): ``--check`` passes on each layout (the
  sequential loop on the same placement), and the streams equal the
  one-process engine's token for token (float32 smoke configs: the
  ranks' other rounding moves no argmax here).
- The pool's placement: on (2, 1) each rank holds its block of the slots
  (``cache_specs``), on (1, 2) all slots with half the KV heads, and
  the recurrent states the heads or units the rank runs (Mamba2's ``h``
  H/M heads and ``conv`` d_inner/M channels, the mLSTM's ``C`` and
  ``n`` H/M heads, the sLSTM's ``c`` and ``n`` D/M units); a
  reset zeroes only the rank's own slots of the mask; a slot count that
  does not divide the data ranks stays whole on both.
- ``--no-mesh`` serves on each rank alone (layout (1, 1)) and gives the
  same streams; ``--production-mesh`` refuses two ranks, naming 256.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.dist import process_group as pg
from repro_torch.launch import serve as tserve
from repro_torch.serve import CachePool, slot_rows

WORLD = 2
ARGS = ["--device", "cpu", "--requests", "6", "--slots", "4",
        "--prompt-len", "8", "--prompt-spread", "3", "--max-new-tokens",
        "6", "--max-len", "32", "--straggler-p", "0.2", "--check"]
RUNS = {("granite-3-8b", 2), ("granite-3-8b", 1), ("deepseek-moe-16b", 2),
        ("zamba2-1.2b", 2), ("xlstm-1.3b", 2)}


def _cfg(arch):
    """The smoke config an arch serves at here: the xLSTM's at 4 layers,
    one mLSTM and one sLSTM a super-block (its 2-layer smoke variant has
    no super-block at 7:1)."""
    cfg = get_config(arch).smoke_variant()
    if arch == "xlstm-1.3b":
        cfg = cfg.with_overrides(n_layers=4, slstm_ratio=1)
    return cfg


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
        for key, (name, args) in jobs.items():
            try:
                out[key] = ("ok", globals()[name](rank, *args))
            except SystemExit as exc:
                out[key] = ("exit", str(exc.code))
            except BaseException:           # reported by the job's test
                out[key] = ("error", traceback.format_exc())
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


_DONE = {}


def _results(key, tmp_path_factory, ok=True):
    if not _DONE:
        tmp = tmp_path_factory.mktemp("serve_group")
        mp.spawn(_entry, args=(WORLD, str(tmp), _jobs()), nprocs=WORLD,
                 join=True)
        _DONE.update(world=[torch.load(tmp / f"out{r}.pt",
                                       weights_only=False)
                            for r in range(WORLD)])
    outs = []
    for rank_out in _DONE["world"]:
        status, value = rank_out[key]
        if ok and status != "ok":
            raise AssertionError(f"rank job {key} raised:\n{value}")
        outs.append((status, value) if not ok else value)
    return outs


# ----------------------------------------------------- the rank jobs

def _serve(rank, arch, model, extra=()):
    out = tserve.main(["--arch", arch, *ARGS, *extra], _cfg(arch),
                      model=model)
    return {"results": out["results"], "summary": out["summary"]}


def _pool(rank, model, n_slots):
    """Each leaf's shape of this rank's pool, and which slots a reset of
    every even slot zeroed."""
    cfg = get_config("granite-3-8b").smoke_variant()
    workers = pg.init_workers("cpu", model=model)
    pool = CachePool(cfg, n_slots, 16, device="cpu", workers=workers)
    for leaf in (pool.cache["layers"]["k"], pool.cache["layers"]["v"]):
        leaf.fill_(1.0)
    mask = np.arange(n_slots) % 2 == 0
    pool.reset_slots(mask)
    k = pool.cache["layers"]["k"]
    rows = slot_rows(n_slots, workers)
    return {"k": tuple(k.shape), "pos": tuple(pool.cache["layers"][
                "pos"].shape),
            "rows": (rows.start, rows.stop),
            "zeroed": [bool((k[:, i] == 0).all())
                       for i in range(k.shape[1])]}


def _state_pool(rank, arch):
    """Each recurrent state leaf's shape of this rank's pool on (1, 2)."""
    workers = pg.init_workers("cpu", model=2)
    pool = CachePool(_cfg(arch), 4, 16, device="cpu", workers=workers)
    return {f"{group}/{k}": tuple(v.shape)
            for group, leaves in pool.cache.items() if group != "attn"
            for k, v in leaves.items()}


def _jobs():
    jobs = {("serve", arch, model): ("_serve", (arch, model))
            for arch, model in sorted(RUNS)}
    jobs[("serve", "no-mesh")] = ("_serve", ("granite-3-8b", None,
                                             ["--no-mesh"]))
    jobs[("serve", "production")] = ("_serve", ("granite-3-8b", None,
                                                ["--production-mesh"]))
    for model, n in ((1, 4), (2, 4), (1, 3)):
        jobs[("pool", model, n)] = ("_pool", (model, n))
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        jobs[("state_pool", arch)] = ("_state_pool", (arch,))
    return jobs


# ------------------------------------------------------------ the tests

_ONE = {}


def _one_process(arch):
    if arch not in _ONE:
        _ONE[arch] = tserve.main(["--arch", arch, *ARGS],
                                 _cfg(arch))["results"]
    return _ONE[arch]


@pytest.mark.parametrize("arch,model", sorted(RUNS))
def test_engine_over_a_worker_group_matches_one_process(
        arch, model, tmp_path_factory):
    outs = _results(("serve", arch, model), tmp_path_factory)
    one = _one_process(arch)
    layout = {"data": WORLD // model, "model": model}
    for out in outs:
        s = out["summary"]
        assert s["check_passed"] is True
        assert s["layout"] == layout
        assert s["slots_per_rank"] == 4 // layout["data"]
        assert set(out["results"]) == set(one)
        for uid, toks in one.items():
            np.testing.assert_array_equal(out["results"][uid], toks)


@pytest.mark.parametrize("model,n_slots", [(1, 4), (2, 4), (1, 3)])
def test_pool_is_placed_by_cache_specs(model, n_slots, tmp_path_factory):
    outs = _results(("pool", model, n_slots), tmp_path_factory)
    cfg = get_config("granite-3-8b").smoke_variant()
    data = WORLD // model
    split = n_slots % data == 0 and data > 1
    local = n_slots // data if split else n_slots
    kv = cfg.n_kv_heads // model
    for r, out in enumerate(outs):
        assert out["k"] == (cfg.n_layers, local, 16, kv, cfg.head_dim)
        assert out["pos"] == (cfg.n_layers, local)
        lo = r * local if split else 0
        assert out["rows"] == (lo, lo + local)
        assert out["zeroed"] == [(lo + i) % 2 == 0 for i in range(local)]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_states_hold_the_ranks_heads(arch, tmp_path_factory):
    outs = _results(("state_pool", arch), tmp_path_factory)
    cfg = _cfg(arch)
    D = cfg.d_model
    if arch == "zamba2-1.2b":
        d_inner = cfg.ssm_expand * D
        H = d_inner // 64
        L = cfg.n_layers
        want = {"ssm/h": (L, 4, H // 2, cfg.ssm_state, 64),
                "ssm/conv": (L, 4, cfg.ssm_conv - 1, d_inner // 2)}
    else:
        n_super = cfg.n_layers // (cfg.slstm_ratio + 1)
        n_m = n_super * cfg.slstm_ratio
        P = D // cfg.n_heads
        want = {"mlstm/C": (n_m, 4, cfg.n_heads // 2, P, P),
                "mlstm/n": (n_m, 4, cfg.n_heads // 2, P),
                "slstm/c": (n_super, 4, D // 2),
                "slstm/n": (n_super, 4, D // 2)}
    for out in outs:
        assert out == want


def test_no_mesh_serves_alone_and_production_refuses(tmp_path_factory):
    for out in _results(("serve", "no-mesh"), tmp_path_factory):
        assert out["summary"]["layout"] == {"data": 1, "model": 1}
        assert out["summary"]["check_passed"] is True
        one = _one_process("granite-3-8b")
        for uid, toks in one.items():
            np.testing.assert_array_equal(out["results"][uid], toks)
    for status, code in _results(("serve", "production"),
                                 tmp_path_factory, ok=False):
        assert status == "exit" and code == "2"
